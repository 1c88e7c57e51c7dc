"""host_issue_ms: mean host time from a call's start until it returns,
before its synchronize, over the window's calls outside the traced
stretch, in ms."""


def read(obs):
    issue = obs.get("issue_s")
    if not issue:
        return None
    return 1e3 * sum(issue) / len(issue)
