"""GOOD: the repo's atomic-publish idiom — stage the payload under a
tmp name in the same directory, then os.replace() it into place."""
import json
import os


def publish_generation(protocol_dir, generation, step):
    payload = json.dumps({"generation": generation, "step": step})
    tmp = protocol_dir / ".generation.tmp"
    tmp.write_text(payload)
    os.replace(tmp, protocol_dir / "generation")
