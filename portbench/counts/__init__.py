"""The benchmark's own counts of work, from the configuration's widths and a
request's (L, N), never from the program: model FLOPs of a forward
(torch.utils.flop_counter over the frozen reference run on the meta device,
so nothing is computed), the FAVOR+ launches the serving path makes, and the
published peaks (`peaks.json`)."""
