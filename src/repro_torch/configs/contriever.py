"""Embedding encoder configs for the cache's semantic similarity calculator.

The paper's measured default is facebook/contriever-msmarco (a BERT-base
bi-encoder with mean pooling, 110M params); e5-large-v2 is the second local
model in Fig 7. Both are expressed here as encoder configs for the PyTorch
encoder in repro_torch.core.embeddings.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    vocab_size: int
    max_seq_len: int = 512
    pooling: str = "mean"  # contriever-style mean pooling
    norm_eps: float = 1e-12
    dtype: str = "float32"


CONTRIEVER_MSMARCO = EncoderConfig(
    name="contriever-msmarco",
    num_layers=12,
    d_model=768,
    num_heads=12,
    d_ff=3072,
    vocab_size=30522,
)

E5_LARGE_V2 = EncoderConfig(
    name="e5-large-v2",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    d_ff=4096,
    vocab_size=30522,
)


def smoke() -> EncoderConfig:
    return EncoderConfig(
        name="contriever-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        d_ff=128,
        vocab_size=4096,
        max_seq_len=128,
    )
