"""Per-sonde-family decoder models.

Each model module exposes:
  * demod/frame constants (baud, header, frame length),
  * a stateful ``*Decoder`` class: ``decode_bits(bits, soft) -> [telemetry]``
    producing dicts in the reference JSON schema
    (reference auto_rx/autorx/decode.py:59-109),
  * an ``encode_frame`` test fixture building valid frames (the reference
    validates against recorded captures; we synthesize ground truth and
    additionally check bit-exactness against the reference C binaries when
    an oracle build is available).

Registry maps auto_rx type names to model classes.
"""

_REGISTRY = {}


def register(name):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


_MODEL_MODULES = [
    "rs41", "dfm", "m10", "imet54", "mrz", "lms6", "meisei", "mts01",
    "imet4", "weathex", "rs92", "dropsonde", "mk2lms",
]


def _load_all():
    import importlib
    import logging
    for mod in _MODEL_MODULES:
        try:
            importlib.import_module(f"radiosonde_auto_rx_tpu_torch.models.{mod}")
        except ImportError:
            # keep the rest of the registry usable, but NEVER silently:
            # a swallowed failure here makes a whole sonde family vanish
            logging.getLogger("models").exception(
                "model module %r failed to import — its sonde types "
                "will be unavailable", mod)


def get_model(name: str):
    _load_all()
    return _REGISTRY[name]


def available_models():
    _load_all()
    return dict(_REGISTRY)
