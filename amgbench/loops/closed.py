"""One client in a closed loop: the next request follows the answer to
the last, as a time-stepping code waits for each solve."""


def serve(window, traffic):
    clients = int(traffic.get("clients", 1))
    if clients != 1:
        raise ValueError(f"the closed loop serves one client, not {clients}")
    i = 0
    while not window.over(i):
        i += 1
        window.request(i)
