"""MIMIC single-task experiment with a ``TransformerEncoder`` on every source
(PyTorch twin of ``pipelines/mimic/mimic_transformer_pipeline.py``): the
single-task protocol of ``mimic_single_task_pipeline`` with
``MimicConfig(encoder_type="transformer", dropout=0.0)``, so its rows go to
that pipeline's results CSV.

    python -m multimodn_tpu_torch.pipelines.mimic.mimic_transformer_pipeline -e 3

runs on the GPU; ``main(argv, cfg, device="cpu")`` runs on the CPU.
"""
import dataclasses

from multimodn_tpu_torch.pipelines.mimic import mimic_single_task_pipeline
from multimodn_tpu_torch.pipelines.mimic.common import MimicConfig


def main(argv=None, cfg: MimicConfig = None, device=None):
    """The single-task pipeline with transformer encoders; a given ``cfg``
    keeps its other fields."""
    cfg = MimicConfig(encoder_type="transformer", dropout=0.0) if cfg is None \
        else dataclasses.replace(cfg, encoder_type="transformer")
    return mimic_single_task_pipeline.main(argv=argv, cfg=cfg, device=device)


if __name__ == "__main__":
    main()
