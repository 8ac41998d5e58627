"""The port's dry run on a fake 2x2 mesh for the last three families
(reduced): deepseek (MLA + MoE with shared experts; its train cell is a
recorded error, ROADMAP Queue 3), the zamba2 hybrid and the llava VLM."""
import pytest
import torch

from test_torch_dryrun import check_family, family_cells

torch.set_num_threads(1)

FAMILIES_C = ("deepseek-v2-lite-16b", "zamba2-7b", "llava-next-34b")


@pytest.fixture(scope="module")
def cells_c():
    return family_cells(FAMILIES_C)


@pytest.mark.parametrize("arch", FAMILIES_C)
def test_family_kinds_on_fake_2x2(cells_c, arch):
    check_family(cells_c, arch)
