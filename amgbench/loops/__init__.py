"""Traffic loops: how requests reach the program within the window.

A traffic mix's ``loop`` names the module ``loops/<name>.py``, whose
``serve(window, traffic)`` calls ``window.request(i, since)`` for i = 1,
2, ... until ``window.over(i)``; ``since`` is the host time the request
counts from (None: the call), so that a loop with arrivals counts the
wait in the queue.  A new way of offering load is a new file here.
"""
