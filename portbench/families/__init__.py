"""Model families: one module a family (``<model_type>.py``), chosen by
the configuration's own published ``model_type`` (``spec.Cell.family``;
a configuration that names none is read as ``llama``).  A name that
several families of one architecture share is a module that imports the
one that holds the code (``mistral.py``, ``mixtral.py``).

The family owns every decision that depends on the architecture; the
drivers, readers, references and calibration call these names and branch
on no kind of model.  ``cfg`` is what ``port_config`` returns; a table
maps each leaf name to ``(shape, fan_in, dtype)`` as ``weights.draw``
takes them (fan-in 0: a norm).

The configuration and the parameters:

- ``port_config(hf)``: the port's configuration of a published
  ``config.json``; raises where the family cannot run it as published;
- ``globals_table(cfg)``, ``layer_table(cfg, layer)``: the leaves outside
  the layers (drawn as layer -1) and those of layer ``layer``; every
  (leaf, layer) is one draw (``weights.draw``), so the program and the
  reference get the same weights from a seed;
- ``program_params(cfg, seed, device)``: the program's parameter tree;
- ``program_slice(params, name, layer)``: ``(tensor, index)``, where leaf
  ``name`` of layer ``layer`` lies in that tree (``index`` None: the whole
  tensor), for the check's reads of the state and the optimizer's moments.

The program:

- ``train_program(cfg, params, opt, compile_cache)``: the train state over
  ``params`` and the step (``compile_cache`` None off the card);
- ``engine(cfg, params, settings, device, compile_cache)``: the serving
  engine, ``settings`` the cell's ``engine`` entry;
- ``SERVE_RANGES``: (module, attribute, label) of the family's functions
  that a serving cell's traced stretch opens a range around.

The routing the reference follows (a family that routes nothing returns
None and False):

- ``route_tap(cfg)``: None, or a tap the drivers install
  (``install(patches)``), switch (``enabled``) and read (``calls``; a
  training step's by layer with ``by_layer(calls)``: per layer the
  program's router logits and capacity, or None);
- ``served_routes(cfg, calls, device)``: the served check's follower of
  the program's tapped calls (``route(layer, seq)``, ``mean``, ``worst``;
  ``judge.ProgramRoutes``), None where no whole forward was tapped, False
  where the family routes nothing;
- ``replayed_routes(cfg, routes)``: the follower of another reference's
  own router logits (the control's), or False.

The plain reference, float32 PyTorch (``g``: the global leaves by name,
``w``: one layer's; ``mm`` or ``mms``: the matmuls a precision gives,
``reference/training.py``):

- ``ref_embed(cfg, g, ids)`` and ``ref_embed_grads(cfg, g, ids, dout)``:
  the hidden states of token ids, and the global leaves' gradients given
  theirs;
- ``ref_head(cfg, g, x, mm)``: the logits ``[N, V]`` of final hidden
  states;
- ``ref_layer(cfg, layer, x, w, mms, follow)``: a training layer on
  ``[B, S, D]``: ``(x, aux loss or None, router logits or None)``,
  routing as ``follow`` (another side's logits and capacity) where given;
  ``ref_aux_weight(cfg)``: the weight of each layer's aux loss;
- ``ref_serve_layer(cfg, layer, x, w, route)``: a served layer on one
  sequence ``[n, D]``: ``(x, router logits or None)``;
- ``int8_control(name, w)``: leaf ``name`` as the served check's int8
  control reads it.

The yardsticks:

- ``train_flops(cfg, batch, seq)``: the model operations of a trained
  step (``mfu.train``);
- ``flash_least_s(cfg, batch, seq, n_fwd, n_bwd)``: the least time of
  ``n_fwd`` K1 and ``n_bwd`` K2 launches of a trained step at that shape
  (``flash_roofline.train``).
"""
