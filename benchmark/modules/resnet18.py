"""The program's ``ResNet`` encoder, which is ResNet-18 at fixed widths:
a configuration that asks for other widths is refused."""
from multimodn_tpu_torch.encoders import ResNet
from multimodn_tpu_torch.encoders.resnet import BLOCKS_PER_STAGE, STAGES


def program(entry: dict, state_size: int):
    if tuple(entry["widths"]) != tuple(STAGES) or \
            any(n != BLOCKS_PER_STAGE for n in entry["blocks"]) or \
            entry["stem_width"] != STAGES[0] or entry["stem_kernel"] != 7:
        raise ValueError("the program's ResNet is ResNet-18 only")
    return ResNet(state_size=state_size)
