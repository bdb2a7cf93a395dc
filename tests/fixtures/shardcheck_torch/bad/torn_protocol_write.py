"""BAD: the generation marker is written in place -> SC503. A reader
polling the protocol dir can observe a truncated payload mid-write."""
import json


def publish_generation(protocol_dir, generation, step):
    payload = json.dumps({"generation": generation, "step": step})
    (protocol_dir / "generation").write_text(payload)
