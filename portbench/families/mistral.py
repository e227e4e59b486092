"""``model_type`` ``mistral``: the Llama family (``llama.py``)."""

from portbench.families.llama import *  # noqa: F401,F403
