"""Parallelism of the port: layouts, the USP process-group mesh, the
Ulysses all-to-all, the dense and the block-sparse rings, the USP layers
over them (the async, head-group pipelined one too), tensor parallelism's
f and g, the GPipe pipeline, the expert-parallel MoE MLP and ZeRO-1/2/3."""

from long_context_attention_tpu_torch.parallel.layouts import (  # noqa: F401
    LAYOUTS,
    bidir_position_descriptor,
    extract_local,
    layout_permutation,
    permute_for_layout,
    position_descriptor,
    positions_from_descriptor,
    segment_ids_from_cu_seqlens,
    unpermute_from_layout,
)
from long_context_attention_tpu_torch.parallel.mesh import (  # noqa: F401
    SEQ_AXES,
    MeshAxes,
    UspMesh,
    make_usp_mesh,
    mesh_axis,
    seq_shard,
    seq_unshard,
    usp_rank_grid,
)
from long_context_attention_tpu_torch.parallel.moe import (  # noqa: F401
    MoEConfig,
    init_moe_params,
    moe_mlp_local,
    moe_param_specs,
)
from long_context_attention_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply,
)
from long_context_attention_tpu_torch.parallel.tp import (  # noqa: F401
    psum_for_value,
    tp_region_input,
    tp_region_output,
)
from long_context_attention_tpu_torch.parallel.ring import (  # noqa: F401
    RingComm,
    RingConfig,
    ring_attention_local,
)
from long_context_attention_tpu_torch.parallel.ring_sparse import (  # noqa: F401
    ring_sparse_attention_local,
)
from long_context_attention_tpu_torch.parallel.ulysses import (  # noqa: F401
    PendingScatter,
    gather_heads,
    gather_seq,
    scatter_heads,
    ulysses_attention_local,
)
from long_context_attention_tpu_torch.parallel.usp import (  # noqa: F401
    AsyncLongContextAttention,
    LongContextAttention,
    UlyssesAttention,
    async_usp_attention_local,
    ulysses_sparse_attention_local,
    usp_attention_local,
    usp_ring_sparse_attention_local,
)
from long_context_attention_tpu_torch.parallel.zero import (  # noqa: F401
    init_zero_opt_state,
    make_zero3_train_step,
    make_zero_train_step,
    shard_params_zero3,
    zero3_param_specs,
    zero_param_specs,
)
