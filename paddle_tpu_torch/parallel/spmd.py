"""DistConfig and `attach` (counterpart of paddle_tpu/parallel/spmd.py:43,
:87): a mesh attached to a Program. The executor runs a program whose
attached mesh has pp > 1 through the pipeline runner
(parallel/pipeline.py), one stage a device of the mesh's pp axis.

The reference's DistConfig also carries GSPMD sharding rules: parameter
rules and state specs. The port's takes the mesh only; any other argument
raises (ROADMAP item 16).
"""
from __future__ import annotations

from typing import Optional

from .mesh import Mesh, get_mesh


class DistConfig:
    def __init__(self, mesh: Optional[Mesh] = None, **unported):
        if unported:
            raise NotImplementedError(
                f"DistConfig({', '.join(sorted(unported))}=...): sharding "
                f"rules and state specs are not ported yet; the port's "
                f"DistConfig takes the mesh only (ROADMAP item 16)")
        self.mesh = mesh

    def resolve_mesh(self) -> Optional[Mesh]:
        return self.mesh if self.mesh is not None else get_mesh()

    @property
    def pp(self) -> int:
        mesh = self.resolve_mesh()
        return 1 if mesh is None else int(mesh.shape.get("pp", 1))


def attach(program, dist_config: DistConfig):
    """Attach a DistConfig to a Program; the Executor picks it up."""
    program._dist_config = dist_config
    program.bump_version()
    return program
