"""Sequence parallelism of the port: layouts, the USP process-group mesh,
the Ulysses all-to-all, the sparse ring and the block-sparse USP layers
(the dense ring comes in a later slice)."""

from long_context_attention_tpu_torch.parallel.layouts import (  # noqa: F401
    LAYOUTS,
    extract_local,
    layout_permutation,
    permute_for_layout,
    position_descriptor,
    positions_from_descriptor,
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
    usp_ring_sparse_attention_local,
)
