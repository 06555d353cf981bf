"""Version utilities (reference auto_rx/autorx/utils.py:84-158).

``check_autorx_version`` queries the project release feed when the
network allows and degrades to "unknown" offline — a version check must
never block or crash a station.
"""

import json
import logging
import urllib.request

from radiosonde_auto_rx_tpu_torch import __version__

log = logging.getLogger("version")

RELEASE_URL = ("https://api.github.com/repos/projecthorus/"
               "radiosonde_auto_rx/releases/latest")


def version_startup_check():
    log.info("radiosonde_auto_rx_tpu_torch version %s", __version__)
    return __version__


def check_autorx_version(timeout: float = 5.0) -> dict:
    """Compare the local version against the latest release.

    Returns {"local", "latest", "up_to_date"}; latest is "unknown" when
    the feed is unreachable (offline stations are normal)."""
    latest = "unknown"
    try:
        with urllib.request.urlopen(RELEASE_URL, timeout=timeout) as r:
            latest = json.load(r).get("tag_name", "unknown")
    except Exception as e:
        log.debug("version check unavailable: %s", e)
    return {
        "local": __version__,
        "latest": latest,
        "up_to_date": latest in ("unknown", __version__),
    }
