"""The serve command (``repro_torch.launch.serve``) with every completion's
tokens printed on one line, by rank 0 of a torchrun group or by the only
process: ``python tools/serve_tokens.py <serve flags>``."""
import os
import sys

from repro_torch.launch import serve

out = serve.main(sys.argv[1:])
if os.environ.get("RANK", "0") == "0":
    print("TOKENS", sorted((c.uid, list(c.tokens)) for c in out["completions"]))
