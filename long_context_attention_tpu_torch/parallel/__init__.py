"""Sequence parallelism of the port: layouts, the USP process-group mesh,
the Ulysses all-to-all, the dense and the block-sparse rings, and the USP
layers over them."""

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
    seq_shard,
    seq_unshard,
    usp_rank_grid,
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
    gather_heads,
    scatter_heads,
    ulysses_attention_local,
)
from long_context_attention_tpu_torch.parallel.usp import (  # noqa: F401
    LongContextAttention,
    UlyssesAttention,
    ulysses_sparse_attention_local,
    usp_attention_local,
    usp_ring_sparse_attention_local,
)
