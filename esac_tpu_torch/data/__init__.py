"""Scenes: the synthetic box room (``synthetic``), the on-disk dataset
layout and synthetic scenes as datasets (``datasets``), and training-time
augmentation (``augment``)."""
