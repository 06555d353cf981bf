"""The benchmark of radiosonde_auto_rx_tpu_torch's station (see run.py)."""
