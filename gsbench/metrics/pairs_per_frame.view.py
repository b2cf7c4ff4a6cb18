"""Pairs per rendered frame: the program's own count
(``RenderAux.num_pairs``), averaged over the window."""


def read(run):
    if run.kind != "view" or not run.attempted:
        return None
    pairs = run.frame_pairs[:run.attempted]
    return sum(pairs) / len(pairs)
