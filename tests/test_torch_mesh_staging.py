"""Where a training mesh's collectives put their results
(``launch.mesh.TrainMesh``): a CUDA operand on a gloo group is staged
through pinned host memory and its result goes back to the card; any
other operand's result buffers lie where the operand does (a dry run's
fake CUDA tensors on the fake world stay on their device)."""

import torch

from repro_torch.launch.mesh import _empty


def test_result_buffers_lie_where_an_unstaged_operand_does():
    x = torch.empty((4, 3), dtype=torch.bfloat16, device="meta")
    out = _empty(x, (2, 3), staged=False)
    assert out.device.type == "meta" and out.dtype == torch.bfloat16
    assert tuple(out.shape) == (2, 3)
    cpu = _empty(torch.zeros(5, dtype=torch.int32), (5,), staged=False)
    assert cpu.device.type == "cpu" and cpu.dtype == torch.int32
    assert not cpu.is_pinned()
