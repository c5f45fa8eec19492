from multimodn_tpu_torch.baselines.haim import HAIM, HAIMDecoder

__all__ = ["HAIM", "HAIMDecoder"]
