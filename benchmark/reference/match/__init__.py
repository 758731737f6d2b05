"""Frozen copy of the port's landmark model (Lepard matcher, NeCo) on its
plain einsum route."""
