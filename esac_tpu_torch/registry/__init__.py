"""Scene presets and manifest, the device weight cache, scene health and the
scene registry that serves them."""
