"""Device reads a solve: ``solve_mp``'s own count (``return_info``'s
``host_syncs``: each read through ``util.profiling.read_back``), the
mean over the solves of the traced stretch.  With defect-correction CG it
is 1 + rounds + inner iterations."""


def read(record):
    infos = record.stretch_infos
    if not infos or any("host_syncs" not in i for i in infos):
        return None
    return sum(i["host_syncs"] for i in infos) / len(infos)
