"""The parallel layer on torch.distributed — port of nnstreamer_tpu/parallel:
device meshes and the collectives (mesh.py), the rank launcher
(launch.py), DTensor parameter placement (sharding.py), sharded train and
infer steps (train.py) and their checkpoints (checkpoint.py), pipeline
stages (stages.py), expert parallelism (moe.py), sequence parallelism
(ring.py) and tensor-parallel decode and prefill (tp_decode.py,
tp_prefill.py).

One process per rank: code that uses a mesh runs on ranks started by
``launch.RankGroup`` / ``run_ranks`` (or any launcher that initialises the
default process group and sets each rank's device).

``sharded_bundle`` serves a sharded model through ``tensor_filter`` (and
so the query server) with a leader/follower invoke across the ranks
(leader.py); ``composite.py`` checks it behind the query layer.
"""

from .checkpoint import restore_sharded_state, save_sharded_state
from .launch import RankError, RankGroup, run_ranks
from .leader import follow
from .mesh import auto_mesh_2d, make_mesh, mesh_shape
from .moe import (init_moe_params, make_expert_parallel_moe, moe_apply,
                  moe_shardings)
from .sharding import param_shardings, param_spec, shard_params
from .stages import (make_gpipe_apply, sequential_apply, shard_stage_params,
                     stack_stage_params)
from .tp_decode import make_tp_generate, tp_shard_cache, tp_shard_params
from .train import (cross_entropy_loss, make_sharded_infer_step,
                    make_sharded_train_step, sharded_bundle)

__all__ = [
    "auto_mesh_2d", "make_mesh", "mesh_shape", "sharded_bundle",
    "RankError", "RankGroup", "run_ranks", "follow",
    "param_shardings", "param_spec", "shard_params",
    "cross_entropy_loss", "make_sharded_infer_step", "make_sharded_train_step",
    "make_gpipe_apply", "sequential_apply", "shard_stage_params",
    "stack_stage_params",
    "init_moe_params", "make_expert_parallel_moe", "moe_apply",
    "moe_shardings",
    "restore_sharded_state", "save_sharded_state",
    "make_tp_generate", "tp_shard_cache", "tp_shard_params",
]
