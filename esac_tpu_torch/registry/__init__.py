"""Scene presets and the scene-serving entry point."""
