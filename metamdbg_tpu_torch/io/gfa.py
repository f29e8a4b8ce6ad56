"""GFA read utility — the GfaParser counterpart
(src/graph/GfaParser.hpp:1-1062).

The port's copy of metamdbg_tpu/io/gfa.py (pure Python). The reference's
GfaParser is a tokenizer + S/L record reader that backs its dev tools
(`map` coloring, graph re-export, ContigFeature); the live pipeline writes
GFA inline. Same split here: pipeline/gfa.py and pipeline/mapref.py write
or rewrite GFA and use these readers for the parse side.
"""

import dataclasses


@dataclasses.dataclass
class Segment:
    name: str
    seq: str | None          # None when the S line carries '*'
    length: int | None       # LN:i tag when present
    tags: dict


@dataclasses.dataclass
class Link:
    from_name: str
    from_orient: str
    to_name: str
    to_orient: str
    overlap: str


def tokenize(line: str) -> list:
    """GfaParser::tokenize (GfaParser.hpp:36-49): tab-split, no strip of
    interior fields; trailing newline removed."""
    return line.rstrip("\n").split("\t")


def _parse_tags(fields) -> dict:
    tags = {}
    for f in fields:
        parts = f.split(":", 2)
        if len(parts) == 3:
            tags[parts[0]] = (parts[1], parts[2])
    return tags


def iter_records(path: str):
    """Yields Segment and Link records in file order; other line types
    (H, comments) are skipped like the reference's readers."""
    with open(path) as f:
        for line in f:
            if line.startswith("S\t"):
                fields = tokenize(line)
                seq = None if fields[2] == "*" else fields[2]
                tags = _parse_tags(fields[3:])
                length = None
                if "LN" in tags:
                    length = int(tags["LN"][1])
                elif seq is not None:
                    length = len(seq)
                yield Segment(fields[1], seq, length, tags)
            elif line.startswith("L\t"):
                fields = tokenize(line)
                yield Link(fields[1], fields[2], fields[3], fields[4],
                           fields[5] if len(fields) > 5 else "*")


def iter_segments(path: str):
    for rec in iter_records(path):
        if isinstance(rec, Segment):
            yield rec


def iter_links(path: str):
    for rec in iter_records(path):
        if isinstance(rec, Link):
            yield rec


def parse_gfa(path: str):
    """Returns (segments list in S order, links list in L order)."""
    segments, links = [], []
    for rec in iter_records(path):
        (segments if isinstance(rec, Segment) else links).append(rec)
    return segments, links
