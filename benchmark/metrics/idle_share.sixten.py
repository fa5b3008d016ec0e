"""The device's idle share of the traced iteration, in percent: the
reader of ``idle_share.act`` (1 - the union of the device's operation
intervals over the traced window), read on this cell."""
from pathlib import Path

from benchmark.core import load_module

read = load_module(Path(__file__).with_name("idle_share.act.py"),
                   "metric_idle_share_act").read
