"""``MIMICMLPEncoder`` of the program."""
from multimodn_tpu_torch.encoders import MIMICMLPEncoder


def program(entry: dict, state_size: int):
    return MIMICMLPEncoder(state_size, entry["width"], tuple(entry["hidden"]),
                           dropout=entry.get("dropout", 0.0),
                           activation=entry.get("activation", "relu"))
