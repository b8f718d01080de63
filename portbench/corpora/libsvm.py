"""libsvm rows: ``label`` then the dense features as ``id:v.vvvvvv``
(``log(1 + x)`` to six decimals, below 10; the ids zero-padded to the
width of the largest dense id) and the categorical fields as ``id:1``,
ids zero-padded to the width of the largest column id. A Criteo 1TB row as the MLPerf DLRM reference
preprocesses it: 13 counts, then 26 fields at their own offsets."""

from __future__ import annotations

import numpy as np

from portbench.corpora import fixed_width as fw

tiny = fw.tiny


def write(path: str, config: dict, seed: int) -> dict:
    fields, dense = config["fields"], config["dense"]
    nd = fw.id_digits(config["num_col"])
    dd = fw.id_digits(len(dense) + 1)
    dense_tok = dd + 1 + 8 + 1  # id ":" d.dddddd " "
    cat_tok = nd + 3            # id ":1 "
    nf, nc = len(dense), len(fields)
    c0 = 2 + dense_tok * nf  # the first categorical token
    width = c0 + cat_tok * nc
    dense_ids = np.array([d["id"] for d in dense], dtype=np.int64)

    def fill(rng, buf):
        n = len(buf)
        ids = fw.draw_ids(rng, n, fields)
        micro = fw.draw_dense(rng, n, dense)
        buf[:] = ord(" ")
        buf[:, 0] = ord("0") + fw.labels(ids, config["label"])
        if nf:
            fw.put_digits(buf, 2, dense_tok, np.broadcast_to(dense_ids, (n, nf)), dd)
            fw.put_const(buf, 2 + dd, dense_tok, nf, ":")
            fw.put_digits(buf, 3 + dd, dense_tok, micro // 1_000_000, 1)
            fw.put_const(buf, 4 + dd, dense_tok, nf, ".")
            fw.put_digits(buf, 5 + dd, dense_tok, micro % 1_000_000, 6)
        fw.put_digits(buf, c0, cat_tok, ids, nd)
        fw.put_const(buf, c0 + nd, cat_tok, nc, ":1")

    out = fw.write_rows(path, config["corpus_rows"], width, fill, seed)
    return {**out, "format": "libsvm", "width": width}
