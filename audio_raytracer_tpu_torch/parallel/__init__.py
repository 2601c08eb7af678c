"""The sharded tier: a ('rays', 'prims') mesh of process groups on
torch.distributed, the sharded forward and materials step, the cluster
bootstrap.

The names load on first use, so that ``ops`` and ``models`` can import
``parallel.comm`` while this package's modules import them."""

import importlib

_EXPORTS = {
    "make_mesh": "mesh",
    "pad_scene_for_prim_shards": "mesh",
    "shard_scene": "mesh",
    "sharded_forward": "sharded",
    "make_sharded_forward": "sharded",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
