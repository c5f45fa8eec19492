"""The Titanic quick-start in the reference's own idiom (SURVEY.md section
3.4; reference ``pipelines/titanic/titanic_mlp_pipeline.py:19-127``): the
reference's import paths, ``torch.optim.Adam`` over ``model.parameters()``,
``nn.CrossEntropyLoss()``, ``DataLoader``s, an ``F.relu`` encoder and a
``train_epoch`` + ``test`` loop per epoch. It loops over ``range`` where the
reference uses tqdm's ``trange``, so it runs where tqdm is not installed.
Models, history, plot and results go next to this file, as the reference's
do.

Against the port (on the card; ``--device cpu`` on the CPU):

    python -m multimodn_tpu_torch.compat \\
        multimodn_tpu_torch/compat/examples/titanic_mlp_pipeline.py -- -e 20

Against the JAX package's shims, from the repository root:

    PYTHONPATH=. python multimodn_tpu_torch/compat/examples/titanic_mlp_pipeline.py -e 20
"""
import os
import pickle
import sys

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.data import DataLoader

from datasets.titanic import TitanicDataset
from multimodn.decoders import LogisticDecoder
from multimodn.encoders import MLPEncoder
from multimodn.history import MultiModNHistory
from multimodn.multimodn import MultiModN
from pipelines import utils


def main():
    pipeline_name = utils.extract_pipeline_name(sys.argv[0])
    print("Running {}...".format(utils.get_display_name(pipeline_name)))
    args = utils.parse_args()
    torch.manual_seed(args.seed)

    features = ["Fare", "Pclass", "Age", "Sex_male", "Relatives", "Embarked"]
    targets = ["Survived"]
    batch_size = 32
    state_size = 1
    learning_rate = 0.01
    epochs = args.epoch if args.epoch else 300

    dataset = TitanicDataset(features, targets, dropna=True,
                             std=True).partition_dataset()
    train_data, val_data, _test_data = dataset.random_split(
        [0.8, 0.2, 0], args.seed, 0)
    train_loader = DataLoader(train_data, batch_size)
    val_loader = DataLoader(val_data, batch_size)

    encoders = [MLPEncoder(state_size, len(features), (5, 5), F.relu)]
    decoders = [LogisticDecoder(state_size)]
    model = MultiModN(state_size, encoders, decoders, 0.7, 0.3)
    optimizer = torch.optim.Adam(list(model.parameters()), learning_rate)
    criterion = nn.CrossEntropyLoss()
    history = MultiModNHistory(targets)

    for _epoch in range(epochs):
        model.train_epoch(train_loader, optimizer, criterion, history)
        model.test(val_loader, criterion, history, tag="val")

    base_dir = os.path.dirname(os.path.realpath(__file__))
    if args.save_model or args.save_history:
        os.makedirs(os.path.join(base_dir, "models"), exist_ok=True)
    if args.save_model:
        with open(os.path.join(base_dir, "models",
                               pipeline_name + "_model.pkl"), "wb") as f:
            pickle.dump(model, f)
    if args.save_history:
        with open(os.path.join(base_dir, "models",
                               pipeline_name + "_history.pkl"), "wb") as f:
            pickle.dump(history, f)
    if args.save_plot:
        os.makedirs(os.path.join(base_dir, "plots"), exist_ok=True)
        history.plot(os.path.join(base_dir, "plots", pipeline_name + ".png"),
                     targets, show_state_change=False)
    if args.save_results:
        os.makedirs(os.path.join(base_dir, "results"), exist_ok=True)
        history.print_results()
        history.save_results(os.path.join(base_dir, "results",
                                          pipeline_name + ".csv"))


if __name__ == "__main__":
    main()
