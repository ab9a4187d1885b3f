"""pad_share: the share of the token slots given to the decoder in the window
(B × T of each forward, counted by a pre-hook) that held no real token: the
padding of buckets, rows and batches. The real tokens are the reference
tokenizer's count of the window's items."""


def read(run):
    if not run["slots"]:
        return None
    return 100.0 * (1.0 - run["work"]["real_tokens"] / run["slots"])
