"""features_ms.long: mean device time of the features step (one-hot,
reweighting, DCA) per fold, from CUDA events around each call of
``engine.fold.pair_features`` in the traced window."""


def read(ctx):
    spans = ctx["features_ms"]
    if ctx["loop"] != "single" or not spans:
        return None
    return sum(spans) / len(spans)
