"""The warm route: set-up drains one cold epoch of the corpus
(``create_parser(corpus, snapshot=...)`` -> the fused native reader ->
``DeviceIter``) into a snapshot, and every later epoch is served from that
snapshot with ``device_decode=True``: each batch's raw bytes cross as one
span and one launch of kernel K2 (``csrc/widen_span.cu``) decodes it on the
card; no parse, no convert. This is dmlc-core's ``#cachefile`` use: train
several epochs and pay the text parse once. The snapshot lives in a
directory of its own under ``.portbench_cache/snapshot/``, which the
cleanup removes, also when set-up fails."""

from __future__ import annotations

import os
import shutil


def snapshot_dir(corpus: str) -> str:
    """``.portbench_cache/snapshot/<corpus file>/`` beside the corpus's
    directory: one a configuration and seed, as the corpus is."""
    cache = os.path.dirname(os.path.dirname(os.path.abspath(corpus)))
    return os.path.join(cache, "snapshot", os.path.basename(corpus))


def open_pipeline(config: dict, corpus: str, learner, model, device):
    from dmlc_tpu_torch import DeviceIter, create_parser

    where = snapshot_dir(corpus)

    def cleanup():
        shutil.rmtree(where, ignore_errors=True)

    os.makedirs(where, exist_ok=True)
    it = None
    try:
        it = DeviceIter(create_parser(f"{corpus}?format={config['format']}",
                                      snapshot=os.path.join(where, "epoch.snap")),
                        batch_size=config["batch_size"], device=device, device_decode=True,
                        **learner.pipeline_kwargs(model, config))
        for _ in it:  # the cold epoch, written to the snapshot as it ships
            pass
        it.reset()
    except BaseException:
        if it is not None:
            it.close()
        cleanup()
        raise
    return it, cleanup
