"""The cold route: the corpus's text parsed on every epoch,
``create_parser(corpus)`` -> the fused native reader -> ``DeviceIter``
with the learner's keywords. It leaves nothing behind but the corpus."""

from __future__ import annotations


def open_pipeline(config: dict, corpus: str, learner, model, device):
    from dmlc_tpu_torch import DeviceIter, create_parser

    it = DeviceIter(create_parser(f"{corpus}?format={config['format']}"),
                    batch_size=config["batch_size"], device=device,
                    **learner.pipeline_kwargs(model, config))
    return it, lambda: None
