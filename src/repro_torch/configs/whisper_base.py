"""whisper-base — encoder-decoder, 6L each, d_model=512 8H (MHA, d_head=64)
d_ff=2048 vocab=51865.  [arXiv:2212.04356; unverified]

The port's copy of ``repro.configs.whisper_base``.  The conv frontend is
a STUB: ``LM.stub_inputs`` makes precomputed frame embeddings (batch,
frames, d_model) that stand in for it.
"""

from .base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,  # decoder layers
    d_model=512,
    d_ff=2048,
    vocab_size=51865,
    attn=AttnConfig(kind="gqa", n_heads=8, n_kv_heads=8, d_head=64),
    norm="layernorm",
    act="gelu",
    pos="learned",
    encdec=True,
    enc_layers=6,
    enc_seq=1500,
    modality_stub="audio_frames",
    source="arXiv:2212.04356",
)
