"""Checkpoint and resume of the data pipeline — the port of the
repository's ``examples/checkpoint_resume.py``.

    python -m dmlc_tpu_torch.examples.checkpoint_resume [--device cpu] [--uri URI]

A preempted ingest job, simulated: consume three batches, take the
iterator's state as JSON, "restart the process" (a fresh parser and
``DeviceIter``), restore the state and go on; the resumed stream equals an
uninterrupted pass, batch for batch. The corpus is written to ``--uri``
(any registered filesystem: a local path, ``mem://``, ``s3://``, ...), by
default a file in a temporary directory. The batches are made on the card
unless ``--device`` names another device.
"""

import argparse
import json
import os
import tempfile

NUM_COL, BATCH = 8, 128


def make_corpus(uri: str, rows: int = 2000) -> None:
    from dmlc_tpu_torch.io.stream import write_all

    write_all(uri, "".join(
        f"{i % 2} " + " ".join(f"{j}:{(i * 13 + j) % 7}.5" for j in range(NUM_COL)) + "\n"
        for i in range(rows)).encode())


def open_pipeline(uri: str, device):
    from dmlc_tpu_torch import DeviceIter, create_parser

    parser = create_parser(uri, 0, 1, "libsvm", threaded=True, chunk_bytes=8192)
    return DeviceIter(parser, num_col=NUM_COL, batch_size=BATCH, layout="dense", device=device)


def run(uri: str, device=None) -> int:
    """The example on ``uri``; the number of batches of the whole pass."""
    import torch

    make_corpus(uri)
    it = open_pipeline(uri, device)
    consumed = [next(it)[0].clone() for _ in range(3)]
    state_json = json.dumps(it.state_dict())  # persist this with the model
    it.close()
    print(f"consumed 3 batches, checkpoint = {state_json}")

    # --- a simulated restart ---
    it2 = open_pipeline(uri, device)
    it2.load_state(json.loads(state_json))
    resumed = [b[0].clone() for b in it2]
    it2.close()
    print(f"resumed: {len(resumed)} batches")

    # the splice equals an uninterrupted pass
    it3 = open_pipeline(uri, device)
    full = [b[0].clone() for b in it3]
    it3.close()
    if not torch.equal(torch.cat(consumed + resumed), torch.cat(full)):
        raise AssertionError("the resumed stream differs from the uninterrupted pass")
    print("resumed stream matches the uninterrupted pass — OK")
    return len(full)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="the batches' device (default: the card)")
    ap.add_argument("--uri", default=None, help="where to write the corpus")
    args = ap.parse_args(argv)
    if args.uri is not None:
        run(args.uri, args.device)
        return
    with tempfile.TemporaryDirectory() as tmp:
        run(os.path.join(tmp, "train.libsvm"), args.device)


if __name__ == "__main__":
    main()
