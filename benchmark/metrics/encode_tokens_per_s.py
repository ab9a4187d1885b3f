"""encode_tokens_per_s: real (unpadded) tokens of the documents whose
embeddings came back, over the whole window, which ends when the call that
crosses the window's length returns."""


def read(run):
    if run["kind"] != "encode":
        return None
    return run["work"]["real_tokens"] / run["window_s"]
