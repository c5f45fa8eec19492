"""Titanic partitioned pipeline, multi-encoder fusion (PyTorch twin of
``pipelines/titanic/titanic_partitioned_pipeline.py``): 5 features in
partitions [3, 2] -> two MLPEncoders over a state of size 5.

    python -m multimodn_tpu_torch.pipelines.titanic.titanic_partitioned_pipeline -e 5 -m false -y false -p false -r false

runs on the GPU; ``main(argv, device="cpu")`` runs on the CPU.
"""
from multimodn_tpu_torch.encoders import MLPEncoder
from multimodn_tpu_torch.pipelines.titanic.common import TitanicConfig, run

PARTITIONS = [3, 2]

CONFIG = TitanicConfig(
    features=["Fare", "Pclass", "Age", "Relatives", "Embarked"],
    partitions=PARTITIONS,
    state_size=5,
    make_encoders=lambda s, feats: [MLPEncoder(s, n, (5, 5))
                                    for n in PARTITIONS],
)


def main(argv=None, device=None):
    return run(CONFIG, __file__, argv, device)


if __name__ == "__main__":
    main()
