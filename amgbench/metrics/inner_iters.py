"""Krylov iterations a solve: ``solve_mp``'s own count (``return_info``),
``inner_iterations - rounds`` (each defect round counts its starting
residual once), the mean over the solves of the traced stretch."""


def read(record):
    infos = record.stretch_infos
    if not infos:
        return None
    return sum(i["inner_iterations"] - i["rounds"] for i in infos) / len(infos)
