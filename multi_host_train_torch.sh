#!/bin/bash
# Experiment parallelism with the PyTorch/CUDA port: one sweep worker per
# run slot (the counterpart of multi_host_train.sh; the reference's
# multi_gpu_train.sh runs one wandb agent per GPU). Each run is
# train_torch.py (a sweep YAML's "program: train.py", the JAX CLI, is read
# as train_torch.py; another program named there runs as named), and the
# run in slot i sees card i mod (number of cards) alone.
#
# Usage: ./multi_host_train_torch.sh <sweep.yaml> [num_workers]
SWEEP=${1:?usage: multi_host_train_torch.sh <sweep.yaml> [workers]}
WORKERS=${2:-1}
python sweep_torch.py "$SWEEP" --workers "$WORKERS"
