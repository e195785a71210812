#!/usr/bin/env bash
# The PyTorch port's canaries: the six CLI canaries of the JAX package
# (scripts/check.sh), run on the port's modules. Each asserts its
# scenario's claims and prints what the JAX package's canary prints.
#
#   ./scripts/check_torch.sh        # on the CUDA card
#   ./scripts/check_torch.sh cpu    # the plain PyTorch path on the CPU
#
# Stops at the first canary that fails, with its exit code.
set -euo pipefail
cd "$(dirname "$0")/.."

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
device="${1:-cuda}"

echo "== fault engine canary: flap recovery + eviction escape =="
python -m repro_torch.network.faults --device "$device"

echo "== endpoint canary: dead host -> early quiescence + abandonment =="
python -m repro_torch.network.faults --endpoint --device "$device"

echo "== telemetry canary: the flap must be visible in the probe lanes =="
python -m repro_torch.network.telemetry --device "$device"

echo "== link-layer canary: LLR confinement + CBFC buffer bill =="
python -m repro_torch.core.link --device "$device"

echo "== traffic engine canary: plan -> schedule -> simulated step time =="
python -m repro_torch.network.traffic --device "$device"

echo "== sharded engine canary: four devices of the run's kind, bitwise parity =="
python -m repro_torch.network.shard --device "$device"

echo "OK"
