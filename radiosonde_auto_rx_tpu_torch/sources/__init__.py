"""Sample sources: SDR abstraction + IQ ingestion.

The reference allocates one SDR per scan/decode task and builds shell
pipelines around `rtl_sdr`/`rtl_fm`/`ss_iq`/KA9Q `tune`+`pcmrecord`
(reference auto_rx/autorx/sdr_wrappers.py, ka9q.py).  Here a single
wideband capture feeds the on-device channelizer, so the source layer's
job is reduced to: (a) producing one wideband IQ stream (subprocess,
file replay, or UDP), (b) converting wire formats (cu8/cs16) to the
float32 IQ planes the device consumes, and (c) the same
test/reset/spectrum utilities the reference exposes so existing
deployments can be driven unchanged.
"""

from radiosonde_auto_rx_tpu_torch.sources.sdr_wrappers import (  # noqa: F401
    get_power_spectrum, get_sdr_fm_cmd, get_sdr_iq_cmd, get_sdr_name,
    read_ka9q_power_log, read_rtl_power_log, reset_sdr, shutdown_sdr,
    test_sdr)
from radiosonde_auto_rx_tpu_torch.sources.iq_source import (  # noqa: F401
    IQStreamSource, cs16_to_planes, cu8_to_planes, f32c_to_planes)
from radiosonde_auto_rx_tpu_torch.sources.demod_stats import (  # noqa: F401
    DemodStatsTracker)
