"""Launch layer of the port: the LM training loop (``train.py``) and
serving front end (``serve.py``), the launcher of ranks with the data
mesh's smoke test (``dist_smoke.py``), elastic resume and the re-mesh
of a train state onto another mesh (``elastic.py``), the paper's DML /
IV and sweep workloads as single steps and their lowerings on the
production mesh (``dml_cell.py``, ``sweep_cell.py``), and the
production tooling: the meshes (``mesh.py``), the (arch × shape × mesh)
cells (``cells.py``), the per-device cost counter (``op_cost.py``), the
roofline (``roofline.py``) and the multi-pod dry run with the paper's
cell (``dryrun.py``)."""
