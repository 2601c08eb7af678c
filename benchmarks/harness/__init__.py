"""The benchmark's yardstick: loading cells by name, the window and
schedule arithmetic, scene and traffic generation, the device trace's
reduction, the frozen roofline counts and the comparison that decides
``correct``. It imports nothing of the JAX package."""
