"""xlstm-125m [ssm]: 12L d768 4H d_ff=0 vocab=50304 (arXiv:2405.04517).

sLSTM + mLSTM blocks in a 3:1 mLSTM:sLSTM pattern; blocks carry their own
up/down projections so d_ff=0 (ffn="none"). The shapes of the reference's
``configs/xlstm_125m.py``; its remat and microbatch settings have no
counterpart on one card, and its serving flag comes with serving.
"""
from repro_torch.models.registry import ArchSpec
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_head=192,
    d_ff=0,
    vocab=50304,
    pattern=(
        ("mlstm", "none"),
        ("mlstm", "none"),
        ("mlstm", "none"),
        ("slstm", "none"),
    ),
    scan_chunk=256,
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_head=32,
    d_ff=0,
    vocab=256,
    pattern=(
        ("mlstm", "none"),
        ("mlstm", "none"),
        ("mlstm", "none"),
        ("slstm", "none"),
    ),
    scan_chunk=16,
)

SPEC = ArchSpec(name="xlstm-125m", config=CONFIG, smoke=SMOKE)
