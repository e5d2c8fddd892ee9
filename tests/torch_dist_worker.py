"""One rank of the port's multi-process CPU tests of the group's helpers
(gloo), started by ``pointnet2_tpu_torch.parallel.launch.run_ranks``.

    python tests/torch_dist_worker.py collectives OUT --dist_coordinator HOST:PORT \
        --dist_num_processes W --dist_process_id R

It exercises ``parallel.multihost`` and the train CLI's window gather in a
group and writes ``OUT.rank<R>.json``.
"""

import argparse
import json
import sys

import numpy as np
import torch

from pointnet2_tpu_torch.cli import add_dist_flags
from pointnet2_tpu_torch.cli.train import widest_windows
from pointnet2_tpu_torch.parallel import multihost

torch.set_num_threads(2)

# Each rank's calibrated windows, by rank mod 3.
WINDOWS = [(3072, None), (1024, 512), (None, None)]


def collectives(out: str, argv) -> None:
    parser = argparse.ArgumentParser()
    add_dist_flags(parser)
    flags = parser.parse_args(argv)
    multihost.initialize(flags.dist_coordinator, flags.dist_num_processes, flags.dist_process_id, "cpu")
    rank, world = multihost.process_index(), multihost.process_count()
    res = {"data_parallel": multihost.data_parallel(), "backend": multihost.backend()}
    res["allgather"] = multihost.allgather_host(np.array([rank, 10 * rank], np.int64)).tolist()
    res["windows"] = widest_windows(*WINDOWS[rank % 3])
    # Rank r's loss is (r + 1) * sum(S), S the group's sum of (r + 1) * x_r.
    x = torch.full((3,), float(rank + 1), dtype=torch.float64, requires_grad=True)
    total = multihost.all_reduce_sum(x * (rank + 1))
    (total * (rank + 1)).sum().backward()
    res["sum"], res["grad"] = total.tolist(), x.grad.tolist()
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    multihost.assert_replicated(model)
    with torch.no_grad():
        model.bias[0] += 0.25 * (rank == world - 1)
    try:
        multihost.assert_replicated(model)
        res["mismatch"] = None
    except RuntimeError as e:
        res["mismatch"] = str(e)
    res["local_rows"] = multihost.local_rows({"a": np.arange(2 * world * 3).reshape(2 * world, 3)})["a"].tolist()
    multihost.barrier()
    multihost.shutdown()
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    assert sys.argv[1] == "collectives", sys.argv[1]
    collectives(sys.argv[2], sys.argv[3:])
