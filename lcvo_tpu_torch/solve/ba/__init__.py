"""Sliding-window bundle adjustment: the Schur-complement LM solver (``schur``) and
the keyframe ring that feeds it (``window``)."""
