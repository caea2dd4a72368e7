"""probe.cands_per_answer (rows/answer, layer probe): the candidates phase 1
hands on per answer found, summed over the window's queries (QueryStats
n_candidates over n_answers): phase 1's waste."""


def read(run):
    answers = sum(s.n_answers for s in run.stats)
    if not answers:
        return None
    return sum(s.n_candidates for s in run.stats) / answers
