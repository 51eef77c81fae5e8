"""Pairwise similarity sweep and exact pair extraction."""
