"""Shipped material presets.

The reference ships these as ScriptableObject assets
(Assets/ScriptableObjects/AudioMaterials/*.asset, half-decoded values per
SURVEY.md §2.3): (absorption, density, echo). The same table as the JAX
package's ``materials.py``.
"""

MATERIAL_PRESETS = {
    "default": (0.0, 1.0, 1.0),  # AudioMaterialProperties.Default
    "concrete": (0.25, 1.0, 1.0),
    "wood": (0.0, 5.0, 1.0),
    "steel": (0.0, 1.0, 1.0),
    "echo": (0.0, 5.0, 3.0),
}
