"""``model_type`` ``mixtral``: the Llama family (``llama.py``)."""

from portbench.families.llama import *  # noqa: F401,F403
