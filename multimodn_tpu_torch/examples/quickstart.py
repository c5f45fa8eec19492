"""Quick start: Titanic survival with sequential multimodal fusion (the port
of ``examples/quickstart.py``).

On the card: ``python -m multimodn_tpu_torch.examples.quickstart``; on the
CPU: ``python -m multimodn_tpu_torch.examples.quickstart --device cpu``.
Uses the real data/titanic/titanic.csv when present (fetch with
data/titanic/get_data.sh), otherwise the deterministic synthetic stand-in.
The deployment artifact goes to ``--workdir`` (default: a temporary
directory, removed at the end).
"""
import argparse
import contextlib
import os
import tempfile

import numpy as np

from multimodn_tpu_torch import (
    Adam,
    InferenceSession,
    MultiModN,
    MultiModNHistory,
    export_model,
    load_model,
)
from multimodn_tpu_torch.data import ArrayLoader, TitanicDataset
from multimodn_tpu_torch.decoders import LogisticDecoder
from multimodn_tpu_torch.encoders import MLPEncoder

FEATURES = ["Fare", "Pclass", "Age", "Sex_male", "Relatives", "Embarked"]


def main(device=None, workdir=None, epochs=300) -> dict:
    """Train, test, serve and export the quick-start model on ``device``
    (CUDA unless named); the artifact goes under ``workdir`` (default: a
    temporary directory). Returns the model, its history, the validation
    metrics, the session's probabilities before and after the modality,
    and whether the artifact's reload answers as the model does."""
    dataset = TitanicDataset(FEATURES, ["Survived"]).partition_dataset()
    train, val, _ = dataset.random_split((0.8, 0.2, 0), seed=0,
                                         balanced_target_idx=0)

    model = MultiModN(
        state_size=1,
        encoders=[MLPEncoder(1, len(FEATURES), (5, 5))],
        decoders=[LogisticDecoder(1)],
        err_penalty=0.7, state_change_penalty=0.3, device=device)
    history = MultiModNHistory(["Survived"])

    # Train and validation passes, epoch after epoch.
    model.fit(ArrayLoader(train, 32), Adam(0.01), "cross_entropy",
              epochs=epochs, history=history, val_loader=ArrayLoader(val, 32))

    f1, auroc, acc, *_ = model.test(ArrayLoader(val, 32), "cross_entropy")[0]
    print(f"val f1={f1:.3f} auroc={auroc:.3f} acc={acc:.3f}")
    history.print_results()

    # Real-time serving: predictions refresh as each modality arrives.
    session = InferenceSession(model)
    x = np.asarray([s[0][0] for s in (val[i] for i in range(4))],
                   dtype=np.float32)
    state = session.init(4)
    prior = session.decode(state)[0][:, 1]
    print("prior probs:", prior)
    state, probs = session.step(state, 0, x)
    after = probs[0][:, 1]
    print("after tabular modality:", after)

    # Pickle-free deployment artifact.
    with contextlib.ExitStack() as stack:
        root = workdir or stack.enter_context(tempfile.TemporaryDirectory())
        artifact = os.path.join(root, "titanic_artifact")
        export_model(model, artifact)
        reloaded = load_model(artifact, device=device)
        round_trip = bool(np.allclose(reloaded.predict_proba([x])[0],
                                      model.predict_proba([x])[0]))
    print("artifact round-trip OK:", round_trip)
    return {"model": model, "history": history,
            "val": {"f1": float(f1), "auroc": float(auroc),
                    "accuracy": float(acc)},
            "rows": x, "prior": prior, "after": after,
            "artifact": artifact, "round_trip": round_trip}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    parser.add_argument("--workdir", default=None,
                        help="directory for the artifact (default: a "
                             "temporary one)")
    parser.add_argument("--epochs", type=int, default=300)
    args = parser.parse_args()
    main(args.device, args.workdir, args.epochs)
