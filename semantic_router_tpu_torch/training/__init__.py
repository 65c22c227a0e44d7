"""Training on one device: LoRA fine-tunes of the sequence and token
classifiers (``finetune``, ``token_finetune``) and of the embedding trunk
(``embed_finetune``), their shared loop (``loop``), datasets
(``datasets``) and evaluation over the engine (``evaluate``); and the
offline training of the serving selectors' artifacts
(``selection_train``)."""

from .finetune import (
    TrainConfig,
    batch_iterator,
    finetune_classifier,
    load_adapters,
    load_jsonl_dataset,
    save_adapters,
    synthetic_dataset,
)

__all__ = ["TrainConfig", "batch_iterator", "finetune_classifier",
           "load_adapters", "load_jsonl_dataset", "save_adapters",
           "synthetic_dataset"]
