"""Corpus writers, one module a text format, found by the format's name
(``registry.corpus_writer``). Each has ``write(path, config, seed)
-> dict``: the same seed writes the same bytes."""
