"""One rank of tests/test_torch_multihost.py's gloo world.

    python tests/torch_multihost_worker.py HOST:PORT RANK WORLD INPUTS.npz OUT.npz

Joins the process group, lays its ``local_replica_slice`` of the batch in
INPUTS over a two-entry CPU mesh (``global_mesh``), runs
``parallel.mesh.sharded_apply`` on it with its own op rows, gathers the
per-replica digests from every rank and writes its rows of the new state,
the gathered digests and the all-reduced global digest to OUT.  Imports
only torch and the port."""
import sys

import numpy as np
import torch
import torch.distributed as dist

from peritext_tpu_torch import state_to_numpy
from peritext_tpu_torch.ops.state import FIELDS
from peritext_tpu_torch.parallel import (
    assemble_global_states,
    global_mesh,
    initialize_distributed,
    local_replica_slice,
    sharded_apply,
)
from peritext_tpu_torch.parallel.mesh import gather_states


def main(address: str, rank: int, world: int, inputs: str, out: str) -> None:
    initialize_distributed(address, world, rank, backend="gloo")
    try:
        data = np.load(inputs)
        mesh = global_mesh(devices=["cpu", "cpu"])
        sl = local_replica_slice(data["text_ops"].shape[0])
        fields = {f: data[f] for f in FIELDS}
        states = assemble_global_states({f: a[sl] for f, a in fields.items()}, fields, mesh)
        new, digests, total = sharded_apply(mesh)(
            states, *(torch.from_numpy(data[k][sl]) for k in ("text_ops", "mark_ops")),
            torch.from_numpy(data["ranks"]), torch.from_numpy(data["multi"]),
        )
        local = digests.full()
        gathered = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(gathered, local)
        rows = state_to_numpy(gather_states(new))
        np.savez(out, digests=torch.cat(gathered).numpy(), total=np.int64(int(total)),
                 groups=np.int64(mesh.global_shape["replica"]), **rows)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
