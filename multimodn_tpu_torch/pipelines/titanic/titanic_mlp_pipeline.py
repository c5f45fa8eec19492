"""Titanic MLP pipeline, the quick-start (PyTorch twin of
``pipelines/titanic/titanic_mlp_pipeline.py``): 6 features -> one
MLPEncoder(state=1, hidden=(5, 5)) -> LogisticDecoder, 300 epochs.

    python -m multimodn_tpu_torch.pipelines.titanic.titanic_mlp_pipeline -e 5 -m false -y false -p false -r false

runs on the GPU; ``main(argv, device="cpu")`` runs on the CPU.
"""
from multimodn_tpu_torch.encoders import MLPEncoder
from multimodn_tpu_torch.pipelines.titanic.common import TitanicConfig, run

CONFIG = TitanicConfig(
    features=["Fare", "Pclass", "Age", "Sex_male", "Relatives", "Embarked"],
    make_encoders=lambda s, feats: [MLPEncoder(s, len(feats), (5, 5))],
)


def main(argv=None, device=None):
    return run(CONFIG, __file__, argv, device)


if __name__ == "__main__":
    main()
