"""Titanic missingness pipeline, NaNs kept and skipped per sample (PyTorch
twin of ``pipelines/titanic/titanic_missingness_pipeline.py``): the sparse
Cabin_num feature joins, rows with NaN stay, and ``nan_skip='sample'``
lifts the reference's batch_size=1 restriction (``batch_size=1`` with
``nan_skip='batch'`` replicates the reference exactly).

    python -m multimodn_tpu_torch.pipelines.titanic.titanic_missingness_pipeline -e 5 -m false -y false -p false -r false

runs on the GPU; ``main(argv, device="cpu")`` runs on the CPU.
"""
from multimodn_tpu_torch.encoders import MLPFeatureEncoder
from multimodn_tpu_torch.pipelines.titanic.common import TitanicConfig, run

FEATURES = ["Fare", "Pclass", "Age", "Relatives", "Embarked", "Cabin_num"]

CONFIG = TitanicConfig(
    features=FEATURES,
    featurewise=True,
    dropna=False,
    state_size=5,
    batch_size=32,
    epochs=40,
    nan_skip="sample",
    make_encoders=lambda s, feats: [MLPFeatureEncoder(s, 5) for _ in feats],
)


def main(argv=None, device=None):
    return run(CONFIG, __file__, argv, device)


if __name__ == "__main__":
    main()
