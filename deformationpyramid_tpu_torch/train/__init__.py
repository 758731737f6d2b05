"""Training of the learned landmark model (matcher and NeCo)."""
