"""CUDA graphs the loop captured inside the window
(``utils/step_graph.STATS``): the refit's fit for each new row count, and
whatever else a change leaves uncaptured until the window."""


def read(run):
    if run.loop != "adr":
        return None
    return run.captures
