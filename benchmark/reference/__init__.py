"""The plain reference that decides ``correct``: PyTorch and NumPy only.

Nothing here imports the port, JAX or the JAX package, and nothing takes
a value the port made except the outputs it judges (and, where a stage can
only be followed from the port's state, that state, as each module says).
Every product goes through :func:`precision.mm`, so that the control can
run the same reference one precision below float32.
"""
