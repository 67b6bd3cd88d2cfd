"""Neural-network functionals of the port (counterpart of
paddle_tpu/nn)."""
