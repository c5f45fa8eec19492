"""Plain PyTorch reference of the benchmark's configurations.

Written from the published descriptions (MultiModN, Swamy et al. 2023;
torchvision's ResNet-18), in float32, with no kernel, cache or batching of
the program under test. It imports ``torch`` and the other files of this
folder only. Each module kind lives in a file of its own, named by the kind
that a configuration file gives (``configs/<config>.json``): ``leaves``
lists its parameters in the tree layout the benchmark hands to both sides,
``apply`` runs it.
"""
import importlib

KIND_PACKAGE = __name__


def kind(name: str):
    """The reference module of a kind (``reference/<name>.py``)."""
    return importlib.import_module(f"{KIND_PACKAGE}.{name}")
