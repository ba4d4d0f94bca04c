"""The device inventory (the JAX package's ``data/acquire.py:
device_report``, the reference's ``check_gpu.py``). The dataset and
checkpoint downloads of that module are not ported: nothing here downloads.

    python -m vae_gan_mark_tpu_torch.data.acquire
"""

from __future__ import annotations

import json


def device_report() -> dict:
    """The backend, the cards with their memory, and the process group."""
    import torch

    from vae_gan_mark_tpu_torch.parallel import mesh

    cuda = torch.cuda.is_available()
    count = torch.cuda.device_count() if cuda else 0
    info = {"backend": "cuda" if cuda else "cpu",
            "device_count": count,
            "process_count": mesh.process_count(),
            "process_index": mesh.process_index(),
            "devices": [torch.cuda.get_device_name(i) for i in range(count)]}
    memory = []
    for i in range(count):
        free, total = torch.cuda.mem_get_info(i)
        memory.append({"device": f"cuda:{i}", "bytes_limit": total,
                       "bytes_free": free,
                       "bytes_in_use": torch.cuda.memory_allocated(i)})
    info["memory"] = memory
    return info


if __name__ == "__main__":
    print(json.dumps(device_report(), indent=2))
