"""Caption encoder (``models/query_encoder.py`` text path,
``models/clap/tokenizer.py``, ``models/clap/roberta.py``): host clock
around ``get_query_embed('text')``, ending in a synchronise, mean per
batch (traced runs), in ms."""


def read(run, name):
    spans = run.spans.get("query_s")
    if not spans or run.bench.traffic.get("query") != "text":
        return None
    return 1e3 * sum(spans) / len(spans)
