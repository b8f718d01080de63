"""The plain reference: its own text parse, its own FM forward and
backward, its own Adam. Plain numpy and torch; it imports nothing of the
program under test (``portbench/tests`` checks that in a process of its
own)."""
