"""Titanic featurewise pipeline, one encoder per feature (PyTorch twin of
``pipelines/titanic/titanic_featurewise_pipeline.py``): 5
MLPFeatureEncoders, state size 5.

    python -m multimodn_tpu_torch.pipelines.titanic.titanic_featurewise_pipeline -e 5 -m false -y false -p false -r false

runs on the GPU; ``main(argv, device="cpu")`` runs on the CPU.
"""
from multimodn_tpu_torch.encoders import MLPFeatureEncoder
from multimodn_tpu_torch.pipelines.titanic.common import TitanicConfig, run

CONFIG = TitanicConfig(
    features=["Fare", "Pclass", "Age", "Relatives", "Embarked"],
    featurewise=True,
    state_size=5,
    make_encoders=lambda s, feats: [MLPFeatureEncoder(s, 5) for _ in feats],
)


def main(argv=None, device=None):
    return run(CONFIG, __file__, argv, device)


if __name__ == "__main__":
    main()
