"""Milliseconds of the target's ``.ksx`` metadata (names and md5s) per
thousand target entries in set-up: the program's ``index.metadata`` spans
(the md5s and ``metadata.json`` written inside ``index.members``, read
inside ``index.load``) inside the harness's ``target_build`` and
``target_load`` spans, over the configuration's target proteins."""

from kbench.program_spans import setup_spans, total_ms


def read(run):
    built, loaded = setup_spans(run, "target_build"), setup_spans(run, "target_load")
    if built is None or loaded is None:
        return None
    ms = total_ms(built, "index.metadata") + total_ms(loaded, "index.metadata")
    return ms / (run.config["target"]["proteins"] / 1e3) if ms else None
