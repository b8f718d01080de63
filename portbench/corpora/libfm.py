"""libfm rows: ``label field:id:1`` for each categorical field, the field's
position as its number (one digit: at most ten fields), ids zero-padded.
A KDD Cup 2012 track 2 row as LIBSVM's kdd12 holds it, ten fields a row."""

from __future__ import annotations

import numpy as np

from portbench.corpora import fixed_width as fw

tiny = fw.tiny


def write(path: str, config: dict, seed: int) -> dict:
    fields = config["fields"]
    if config["dense"] or len(fields) > 10:
        raise ValueError("libfm writer: categorical fields only, at most ten")
    nd = fw.id_digits(config["num_col"])
    tok = 2 + nd + 3  # "f:" id ":1 "
    width = 2 + tok * len(fields)
    nf = len(fields)

    def fill(rng, buf):
        ids = fw.draw_ids(rng, len(buf), fields)
        buf[:] = ord(" ")
        buf[:, 0] = ord("0") + fw.labels(ids, config["label"])
        fw.put_digits(buf, 2, tok, np.broadcast_to(np.arange(nf), ids.shape), 1)
        fw.put_const(buf, 3, tok, nf, ":")
        fw.put_digits(buf, 4, tok, ids, nd)
        fw.put_const(buf, 4 + nd, tok, nf, ":1")

    out = fw.write_rows(path, config["corpus_rows"], width, fill, seed)
    return {**out, "format": "libfm", "width": width}
