from .config import PianoBartConfig, tiny_config
from .pianobart import (PianoBart, PianoBartLM, SequenceClassification,
                        TokenClassification, attention_mask_from_bars)

__all__ = ["PianoBartConfig", "tiny_config", "PianoBart", "PianoBartLM",
           "SequenceClassification", "TokenClassification",
           "attention_mask_from_bars"]
