"""tpinn_torch.parallel — process meshes for PINN training on
torch.distributed (the port of tpinn.parallel)."""

from tpinn_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    make_multislice_mesh,
    round_count,
    points_sharding,
    replicated,
    shard_data,
    sharded_sampler,
    make_parallel_loss,
    ensemble_init,
    make_ensemble_loss,
    # the port's own: what the training entry points use on a mesh
    counts_rounder,
    gather_data,
    is_writer,
    meshed,
)
