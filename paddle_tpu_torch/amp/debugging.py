"""`amp.debugging` (counterpart of paddle_tpu/amp/debugging.py: operator
stats, the tensor checker, accuracy comparison) is not ported yet: it
rests on the reference's tape, which the O1 policy shares (ROADMAP
Queue 1 item 13). Every name of it raises NotImplementedError."""


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise NotImplementedError(
        f"amp.debugging.{name} is not ported yet (ROADMAP Queue 1 item 13)")
