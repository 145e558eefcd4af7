"""The paper's contribution: generative semantic caching for LLMs."""
from repro_torch.core.adaptive import (  # noqa: F401
    DEFAULT_PRICE_TABLE,
    CostController,
    ModelCostInfo,
    QualityRateController,
    ThresholdPolicy,
    classify_content,
)
from repro_torch.core.client import (  # noqa: F401
    ClientResult,
    EnhancedClient,
    LLMBackend,
    LLMResponse,
    MockLLM,
)
from repro_torch.core.embeddings import (  # noqa: F401
    ContrieverEncoder,
    EmbeddingModel,
    NgramHashEmbedder,
    encoder_from_jax_params,
    get_embedder,
)
from repro_torch.core.generative_cache import GenerativeCache  # noqa: F401
from repro_torch.core.hierarchy import HierarchicalCache  # noqa: F401
from repro_torch.core.request import (  # noqa: F401
    DEADLINE_EXCEEDED,
    GENERATED,
    HIT,
    CacheChunk,
    CacheRequest,
    CacheResponse,
    split_stream_tokens,
)
from repro_torch.core.semantic_cache import CacheResult, GPTCacheLike, SemanticCache  # noqa: F401
from repro_torch.core.store_bank import StoreBank  # noqa: F401
from repro_torch.core.tiers import HostRamTier, SnapshotTier, TierEntry  # noqa: F401
from repro_torch.core.vector_store import Entry, InMemoryVectorStore  # noqa: F401
