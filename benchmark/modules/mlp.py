"""``MLPDecoder`` of the program."""
from multimodn_tpu_torch.decoders import MLPDecoder


def program(entry: dict, state_size: int):
    return MLPDecoder(state_size, tuple(entry["hidden"]), entry["n_classes"],
                      output_activation=entry.get("output_activation",
                                                  "sigmoid"),
                      hidden_activation=entry.get("activation", "relu"))
