"""Audio query encoder (``query_encoder`` audio path, ``audio/resample.py``,
``dsp/mel.py``, ``models/clap/htsat.py``): host clock around
``get_query_embed('audio')``, ending in a synchronise, mean per batch
(traced runs), in ms."""


def read(run, name):
    spans = run.spans.get("query_s")
    if not spans or run.bench.traffic.get("query") != "audio":
        return None
    return 1e3 * sum(spans) / len(spans)
