"""Clustering models."""
