"""End-to-end run on the PyTorch port: train a reduced LM on a *mixed*
AnalogPlan on the synthetic bigram stream, with checkpointing and the
fault-tolerance machinery engaged. The counterpart of
``examples/lm_analog_training.py``, with the same arguments.

The default plan trains attention tiles with RIDER and everything else
with E-RIDER (embeddings / heads stay digital via ``repro_torch.api.lm_plan``):
two policy-split tile groups, each under its own algorithm, in one train
step. Pass ``--algorithm erider`` for the single-policy setup, or any
``pattern=algorithm`` list of your own (see repro_torch/launch/train.py).

Run on the card:  PYTHONPATH=src python examples/torch_lm_analog_training.py
Run on the CPU:   PYTHONPATH=src python examples/torch_lm_analog_training.py --device cpu
"""
import sys

from repro_torch.launch import train


def main():
    argv = ["--arch", "qwen2-0.5b", "--smoke", "--steps", "200",
            "--batch", "8", "--seq", "64", "--ckpt-dir", "/tmp/repro_torch_lm_ckpt",
            "--ckpt-every", "100", "--log-every", "20",
            "--algorithm", "attn=rider,**=erider"]
    # pass through any user overrides (e.g. --steps 500 --device cpu)
    argv.extend(sys.argv[1:])
    train.main(argv)


if __name__ == "__main__":
    main()
