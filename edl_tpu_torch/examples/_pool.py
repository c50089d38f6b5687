"""What the example twins share: their common flags, the pool that runs
a twin's rank program, and the refusal of the reference's real-data
paths."""

from __future__ import annotations

import argparse
import sys
from typing import Any, Callable, Dict

# the reference's --real-data paths read scikit-learn's bundled datasets;
# the port waits for a dataset in the repository (ROADMAP Queue A)
REAL_DATA_ITEM = "9f"


def add_common(ap: argparse.ArgumentParser, devices: int) -> None:
    ap.add_argument("--devices", type=int, default=devices,
                    help="pool ranks (processes), one device slot each")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the ranks compute (the card unless cpu)")


def refuse_real_data(name: str) -> int:
    print(f"{name}: --real-data is not ported yet (ROADMAP Queue A item "
          f"{REAL_DATA_ITEM}: the reference reads scikit-learn's bundled "
          f"datasets, which the card's machine lacks)", file=sys.stderr)
    return 1


# bounds the pool's rendezvous, each collective and the run
TIMEOUT_S = 600.0


def run_on_pool(fn: Callable[[Dict[str, Any]], Any], args: Dict[str, Any],
                devices: int, device: str) -> Any:
    """``fn(args)`` on every rank of a pool of ``devices`` processes on
    ``device``; rank 0's result."""
    from edl_tpu_torch.utils.platform import ProcessPool

    if fn.__module__ == "__main__":
        # run with ``python -m``: the ranks import the module by its name
        import importlib

        name = sys.modules["__main__"].__spec__.name
        fn = getattr(importlib.import_module(name), fn.__name__)
    with ProcessPool(devices, device=device, timeout_s=TIMEOUT_S,
                     threads=1 if device == "cpu" else None) as pool:
        return pool.run(fn, args)[0]


def rank_device(device: str):
    """This pool rank's device."""
    import torch
    import torch.distributed as dist

    from edl_tpu_torch.utils.platform import pool_device

    return (torch.device("cpu") if device == "cpu"
            else pool_device(dist.get_rank(), device))


def first_rank() -> bool:
    import torch.distributed as dist

    return dist.get_rank() == 0
