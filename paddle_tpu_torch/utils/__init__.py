"""Utilities of the port (counterpart of paddle_tpu/utils): the fault
injection harness the serving engine's fault points use."""
