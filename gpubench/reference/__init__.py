"""Plain PyTorch/NumPy references of the stages' semantics. They import
nothing of the program (``sctagger_tpu_torch``) and nothing of the JAX
package: every table the program derives is derived again here from the
generated inputs."""
