"""Demodulators: the channel-batched buffered FSK core.

``FSKConfig``, ``FSKState`` and ``fsk_demod_stream`` are exported as in
the reference package, but loaded on first use: the frame decoders
import ``demod.framing`` in the frame-plane workers, which must not load
torch through this package.
"""

_EXPORTS = ("FSKConfig", "FSKState", "fsk_demod_stream")


def __getattr__(name):
    if name in _EXPORTS:
        from radiosonde_auto_rx_tpu_torch.demod import fsk
        return getattr(fsk, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
