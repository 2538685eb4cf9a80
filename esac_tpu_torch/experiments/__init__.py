"""Counterparts of the root ``experiments/`` scripts: the stage profile
(``profile_stages``) and accuracy against the training budget
(``generalization``)."""
