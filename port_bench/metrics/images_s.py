"""Images whose logits came back to the host in the window, over the
window's seconds."""


def read(rec):
    if rec["kind"] != "cnn_eval":
        return None
    return rec["images"] / rec["window_s"]
