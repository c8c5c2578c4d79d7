"""AdamW with optional int8 moment states, LR schedules, and error-feedback
int8 gradient compression."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    Q8,
    adamw_update,
    global_norm,
    init_opt_state,
    q8_dequantize,
    q8_quantize,
)
from repro_torch.optim.grad_compress import (  # noqa: F401
    compress_decompress,
    compressed_psum,
    ef_compress_tree,
    init_error_buffer,
)
from repro_torch.optim.schedule import constant, inverse_sqrt, warmup_cosine  # noqa: F401
