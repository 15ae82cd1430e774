"""SeamlessM4T-large-v2 [arXiv:2308.11596] — the multimodal
encoder-decoder backbone (12 encoder + 12 decoder layers).

d_model 1024, 16 heads (MHA: kv=16, head_dim 64), d_ff 8192 (ReLU), a
tied vocabulary of 256206.  The speech frontend (mel + conv feature
extractor) is a stub, as in the reference: the encoder takes precomputed
frame embeddings.  long_500k is skipped (full-attention encoder-decoder;
speech segments never reach 500k tokens).
"""

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.encdec import EncDecConfig

SPEC = ArchSpec(
    arch_id="seamless-m4t-large-v2",
    family="audio",
    modality="audio",
    citation="arXiv:2308.11596",
    skip_shapes=("long_500k",),
    skip_reason="full-attention encoder-decoder; 500k decode inapplicable",
    n_prefix_tokens=0,
    model=EncDecConfig(
        name="seamless-m4t-large-v2",
        n_enc_layers=12,
        n_dec_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab=256_206,
        act="relu",
        dtype=torch.bfloat16,
    ),
)
