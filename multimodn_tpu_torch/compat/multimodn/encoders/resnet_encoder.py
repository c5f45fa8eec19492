"""Reference path ``multimodn/encoders/resnet_encoder.py``. The ResNet
encoder is not ported yet (ROADMAP.md Queue A item 19): taking ``ResNet``
from here raises ``ImportError``. The module itself imports, so that every
other path of this tree does."""


def __getattr__(name):
    if name == "ResNet":
        raise ImportError(
            "ResNet is not ported to multimodn_tpu_torch yet (ROADMAP.md "
            "Queue A item 19); use the JAX package's "
            "multimodn_tpu.encoders.resnet")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
