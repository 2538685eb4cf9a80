"""The hypothesis loop: sample -> solve -> score -> select -> refine."""
