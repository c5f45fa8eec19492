"""Shared pipeline CLI (copy of ``pipelines/utils.py``): the reference's
flags and defaults (``pipelines/utils.py:6-62``): -e/--epoch, -s/--seed,
-m/--save_model, -y/--save_history, -p/--save_plot, -r/--save_results."""
from __future__ import annotations

import argparse


def parse_args(extra=None, argv=None):
    parser = argparse.ArgumentParser(description="Pipeline for MultiModN")
    parser.add_argument("-e", "--epoch", dest="epoch", type=int, default=None,
                        help="Number of epochs for MultiModN training")
    parser.add_argument("-s", "--seed", dest="seed", type=int, default=0,
                        help="Set random seed")
    parser.add_argument("-m", "--save_model", dest="save_model",
                        type=string_to_bool, default=True,
                        help="Whether to save model")
    parser.add_argument("-y", "--save_history", dest="save_history",
                        type=string_to_bool, default=True,
                        help="Whether to save history")
    parser.add_argument("-p", "--save_plot", dest="save_plot",
                        type=string_to_bool, default=True,
                        help="Whether to save learning curves")
    parser.add_argument("-r", "--save_results", dest="save_results",
                        type=string_to_bool, default=True,
                        help="Whether to save results")
    if extra:
        extra(parser)
    return parser.parse_args(argv)


def string_to_bool(s):
    if isinstance(s, bool):
        return s
    if s.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if s.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def extract_pipeline_name(filename: str) -> str:
    return filename.split("/")[-1].split(".")[0].replace("_pipeline", "")


def get_display_name(name: str) -> str:
    return name.replace("_", " ").capitalize()
