"""Pairs left by the cull per training step: the program's own count
(``RenderAux.num_kept``), averaged over the window."""


def read(run):
    if run.kind != "train" or not run.kept_pairs:
        return None
    return sum(run.kept_pairs) / len(run.kept_pairs)
