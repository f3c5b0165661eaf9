"""``python -m irdu_tpu_torch.train --config configs/flagship_sigma25.yaml``

The YAML-driven trainer on the card (``--device cpu`` on the host). Reading
the YAML file needs PyYAML; without it, build the configuration as a dict
and hand it to ``irdu_tpu_torch.train.trainer.Trainer``.

On N cards: ``torchrun --nproc_per_node N -m irdu_tpu_torch.train --config
...``; each rank joins the process group from torchrun's environment (NCCL
on the cards, gloo with ``--device cpu``) and trains on
``cuda:{rank % device_count}``; the config's ``parallel`` section splits the
N ranks into data_parallel × tensor_parallel ("auto": N // tensor_parallel)."""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m irdu_tpu_torch.train",
                                     description="irdu_tpu_torch trainer")
    parser.add_argument("--config", "-c", required=True, help="YAML config path")
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--set", "-s", dest="overrides", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="dotted-path config override, YAML-parsed (e.g. -s "
                             "train.max_steps=800 -s datasets.train.csv_path=corpus/train.csv); "
                             "repeatable")
    args = parser.parse_args(argv)

    from irdu_tpu_torch.train.trainer import Trainer
    from irdu_tpu_torch.utils.config import apply_overrides, load_config

    config = apply_overrides(load_config(args.config), args.overrides)
    return Trainer(config, workdir=args.workdir, device=args.device).run()


if __name__ == "__main__":
    main()
