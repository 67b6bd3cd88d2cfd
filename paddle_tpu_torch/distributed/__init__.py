"""Distributed runtime of the port (counterpart of
paddle_tpu/distributed). Only `watchdog.CommWatchdog`, the private
per-engine tick watchdog of the serving SLO layer, is ported so far."""
