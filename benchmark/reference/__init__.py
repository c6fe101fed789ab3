"""The plain reference of the benchmark's cells: PyTorch at float64 (float32
with TF32 off where a product is rounded on purpose), run on the card after
the window.  It imports neither ``jax`` nor the JAX package nor anything of
``reductive_tpu_torch``, and reads the program's outputs only to judge them.
"""
