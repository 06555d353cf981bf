"""``python -m radiosonde_auto_rx_tpu_torch`` — run the station CLI."""

import sys

from radiosonde_auto_rx_tpu_torch.station.main import main

if __name__ == "__main__":
    sys.exit(main())
