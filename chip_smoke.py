#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. card     — the device's name and power limit; TF32 off everywhere;
  2. build    — every kernel of the port from this checkout's sources:
                ``nvcc`` for the CUDA sources (one process per source, all
                started together) while Triton compiles ``pop_adam`` with
                one warm launch; each kernel's registers and spills from
                ptxas, and the HMMA (tensor-core) instructions of each bf16
                ``flash_attention`` instantiation and of each ``ssd`` and
                ``wkv6`` one from its SASS (none fails the run, and so does
                a spill in ``ssd`` or ``wkv6``);
  3. kernels  — each kernel against its plain PyTorch version on the card
                (``pop_matmul`` forward over the serving and training
                shapes and the edges of both its routes' tiles, its
                backward at the training shapes, ``pop_adam`` over ragged
                sizes, per-member lr and step), then timed at the paths'
                shapes beside its bound, its plain version, the PyTorch
                library call that computes the same function, and the M=1
                heads also on the tiled route that the narrow one stands in
                for;
  4. update   — one full-width TD3 population update chained 4 times with
                every kernel, and again with every plain version, from the
                same state, batches and noise: step-1 gradients (the plain
                route's step 1 on the kernel route's ReLU masks, as in
                every update parity phase below, so that a pre-activation
                within rounding of zero takes one derivative on both) and
                the parameters after 4 steps must agree, the backwards of the
                first step, by shape and gradients asked, must be the 12
                that phase 3 times per update step, and each step's 24
                ``pop_matmul`` launches must take the routes the wrapper's
                rule gives, which must be 16 tiled and 8 narrow;
  5. serve    — a seeded population of 8 full-width TD3 actors is written
                in the checkpoint layout and served through the port's CLI
                entry point (``repro_torch.launch.serve.main``, ``--fused-
                linear --batch 256``) in the mean and best modes, with the
                kernel launch counts set to 0 just before each run and read
                just after (3 ``pop_matmul`` launches a batch: 2 tiled, 1
                narrow); answers are checked against the plain ensemble
                on the same serving set and requests, then a newer
                checkpoint must promote and demote members as the
                selection rule says;
  6. train    — the port's training entry point
                (``repro_torch.launch.train.main``: TD3, pendulum, 8
                members, PBT, ``--fused-adam --fused-linear``) with the
                launch counts set to 0 just before and read just after;
                counts, losses, fitness, evolutions and the checkpoint are
                checked, then iteration and update times and the device's
                busy share are measured;
  7. train -> serve — the checkpoint just trained, whose extras carry
                the population's fitness, is served through
                ``repro_torch.launch.serve.main``: the fittest member must
                take slot 0, and the answers are checked against the plain
                ensemble;
  8. LM kernels — ``wkv6`` and ``ssd`` against their plain versions (head
                sizes 32 and 64, chunks 16/64/256 with S of one and eight
                chunks, S = 200 at chunk 8, which their 32-token tiles
                leave ragged, for ``wkv6`` also S = 8 and 24 and mild
                decays at S = 512, for ``ssd`` its state sizes N = 16 and
                32, the model's strided layout, nonzero states, decays as
                strong as the models give, the served prefill's exact
                shape), then timed at that shape beside their bounds;
                ``flash_attention`` against its plain version (head sizes
                32/64/112/128/256, GQA groups 1/2/4/7, S of 1/63/64/65/128/
                129/200/512, the bf16 route's tile edges and a ragged 200
                included, causal and not, both layouts, float32 and bf16),
                then timed at the six dense, hybrid, MoE and frontend
                served shapes (qwen3-moe's GQA group of 8 and musicgen's
                24 heads of 64 among them; pixtral's is qwen3-8b's)
                beside its bound, its plain version and PyTorch's
                ``scaled_dot_product_attention``;
  9. LM parity — ``rwkv6-1.6b`` (2 layers), ``zamba2-7b`` (7: one
                super-block with the shared attention and a 1-layer tail),
                ``qwen2-0.5b``, ``qwen3-8b``, ``qwen2-1.5b`` and
                ``gemma-7b`` (2 layers each; gemma's scaled embeddings,
                GeGLU and head size 256), ``qwen3-moe-30b-a3b`` (2 MoE
                layers, 2 ``flash_attention`` launches) and
                ``deepseek-v2-lite-16b`` (its dense first layer and one MoE
                layer, MLA: no kernel) at full
                width in float32, weights drawn on the card and copied to
                the CPU: a 256-token prefill's last logits and every
                decode-state leaf, card (kernels) against CPU (plain
                versions), the MoE archs' with the card's routing replayed
                on the CPU (``moe_routes``: a route at a top-k tie or a
                capacity edge would otherwise move a token, and the count
                of choices the CPU's own gating makes otherwise is
                logged); a stateless ``lm.forward`` of qwen2-0.5b's and the
                MoE archs' 2 layers, every logit (the MoE archs' last
                logits also held to their prefill's); then a backward
                through
                ``lm.forward`` of zamba2-7b, rwkv6-1.6b and qwen2-0.5b at
                ``.smoke()`` width with every parameter requiring grad: no
                kernel launches and every gradient equals the CPU's; and
                each of ``flash_attention``, ``wkv6`` and ``ssd`` raises on
                a CUDA tensor that requires grad;
 10. LM serve — ``qwen2-0.5b``, ``qwen3-8b``, ``rwkv6-1.6b`` and
                ``zamba2-7b``, then ``qwen3-moe-30b-a3b`` (61 GB of bf16
                weights) and ``deepseek-v2-lite-16b``, then the frontend
                archs ``musicgen-medium`` (fed zero audio frames, as the
                CLI feeds them) and ``pixtral-12b`` (fed no patches), at
                full published size through
                ``repro_torch.launch.serve.main`` (``--arch A --batch 4
                --prompt-len 512 --tokens 8``) with every launch count set
                to 0 just before and read just after: exactly 24, 36, 0,
                14, 48, 0, 48 and 40 ``flash_attention`` launches, all on
                the bf16 tensor-core route, 24 ``wkv6`` for
                rwkv6-1.6b and 81 ``ssd`` for zamba2-7b, no other kernel;
                the peak of allocated memory under 70 GB; prefill and
                decode times; one prefill and one decode step profiled;
 11. pop_adam at the LM's size — (4, 494,032,768), qwen2-0.5b's
                population, and (4, 2^28 + 1), one past the old grid's
                limit, with a per-member decay and clip scale: kernel ==
                plain (on the card, over column chunks), in place == out
                of place bit for bit; timed beside its bound, the plain
                version and ``torch._fused_adamw_``;
 12. LM update — qwen2-0.5b, then deepseek-v2-lite-16b (its dense and
                one MoE layer, about 1.03 B parameters a member, the card's
                routing replayed on the CPU), at full width with 2 layers
                in float32, two vectorized population updates on the card
                (one pop_adam launch each) against the same on the CPU:
                losses (deepseek's with the aux term), Adam's first moment
                after each step (the gradients), and the parameters after
                each step;
 13. LM train — qwen2-0.5b at full published size (24 layers, remat, bf16
                over float32 masters), 4 members of 4 x 512 tokens, 4
                steps with PBT every 2, through ``PopTrainer(LMAgent)``
                with the launch counts set to 0 just before and read just
                after (one pop_adam launch a step, no other kernel):
                losses, lineage, tokens/s per member of each backend, the
                device's busy share and the peak of allocated memory
                (under 70 GB);
 14. LM CLI — ``repro_torch.launch.train.main --arch A --smoke`` for
                qwen2-0.5b, qwen3-moe-30b-a3b and deepseek-v2-lite-16b
                with each backend: launch counts, evolutions, and the
                checkpoint read back bit for bit;
 15. Fig. 2 — TD3 at the repo's width, batch 256, 8 chained steps a
                call, N = 1, 8, 32: ms per member-update-step of the
                sequential and the vectorized backend, and each one's
                ratio of a call's time at N = 32 to N = 1;
 16. shared update — the shared-critic update (§4.2) at full width (N=8,
                B=256, obs 17, act 6, half the members training, a
                constant DvD coefficient, probe 20) chained 4 times with
                every kernel and again with every plain version: step-1
                gradients, the parameters after 4 steps, members 4-7 bit
                for bit at their start, 6 backwards in step 1, and 9
                ``pop_matmul`` launches (6 tiled, 3 narrow) and 1
                ``pop_adam`` a step;
 17. shared kernels — ``pop_matmul`` at the DvD probe's shapes (x (20, 17)
                broadcast over 8 members) and the update's actor layers,
                and ``pop_adam`` at N=8 with the actor's P, each against
                its plain version, timed beside its bound, the plain
                version and the library call;
 18. CEM-RL — ``repro_torch.examples.cemrl.run`` on pendulum (N=10, 3
                iterations) with the launch counts set to 0 just before
                and read just after: the counts the code gives, lineage
                all -1 at every evolve, CEM's noise decaying by 0.999 an
                evolve, the mean of its variance, finite fitness and
                losses; ms per iteration and the busy share of one more;
 19. DvD — ``repro_torch.examples.dvd.run`` on reacher (N=5, 8
                iterations of 32 updates: past update step 200, where the
                diversity coefficient turns on), counted the same way; the
                probe's logdet at each iteration;
 20. Fig. 4 — the shared-critic update at ``benchmarks/shared_critic.py``'s
                grid (obs 17, act 6, B=256, N=2, 4, 8, 16): ms per update
                of the vectorized and the sequential form, the median of 7
                synchronised calls each with their min and max, their
                ratio, and the busy share of one vectorized call at N=16;
 21. SAC/DQN kernels — ``pop_matmul`` against its plain version at the
                slice's new (K, M): first layers of K 2, 3, 4 and 6,
                SAC's gaussian head and DQN's heads (M 2 and 3, the narrow
                route), forward on both routes and under autograd;
                ``pop_adam`` at SAC's three and DQN's one (N=8, P) and at
                P=1; then each update step's shapes timed beside their
                bounds, the plain versions and the library calls;
 22. SAC/DQN update — each population update at full width (N=8,
                B=256: SAC on pendulum, DQN on cartpole) chained 4 times
                with every kernel and again with every plain version:
                step-1 gradients, the parameters after 4 steps, the first
                step's backwards (SAC 15, DQN 3) and every step's launches
                by route (SAC 24 ``pop_matmul``, 16 tiled and 8 narrow,
                and 3 ``pop_adam``; DQN 6, 4 and 2, and 1); DQN's members
                start near step 100, so the chain syncs some targets;
 23. SAC/DQN train -> serve — ``repro_torch.launch.train.main`` (SAC on
                pendulum, DQN on cartpole, 8 members, PBT, ``--fused-adam
                --fused-linear``) counted as the train phase, its ms per
                iteration and busy share; then the checkpoint served
                through ``repro_torch.launch.serve.main`` (SAC ``mean``,
                DQN ``vote``), 3 ``pop_matmul`` launches a batch, answers
                against the plain ensemble;
 24. torso — DQN's Atari torso (``F.conv2d``) on 32 frames of 84x84x4,
                card against CPU on the same weights, and one per-member
                DQN update with it, card against CPU;
 25. Fig. 2, SAC — the SAC arm beside phase 15's TD3 one (its dims, N =
                1, 8, 32, both backends): the median of 3 calls with their
                min and max (one call where 3 would pass 25 s);
 26. PPO kernels — ``pop_matmul`` against its plain version at the slice's
                new (K, M): first layers of K 3 and 4, the value head
                256->1 and cartpole's logits 256->2, each narrow shape on
                both routes, B up to a rollout's 512, forward and under
                autograd; ``pop_adam`` at PPO's two (N=8, P); then each
                env's update-step shapes timed beside their bounds, the
                plain versions and the library calls;
 27. PPO update — the population update at full width (N=8, B=256:
                pendulum and cartpole) chained 4 times with every kernel
                and again with every plain version: step-1 gradients, the
                parameters after 4 steps, the first step's 6 backwards and
                every step's 6 ``pop_matmul`` launches (4 tiled, 2 narrow)
                and 1 ``pop_adam``;
 28. PPO GAE — one cartpole rollout at the train phase's size, holding
                terminations and truncations: the value call and the
                advantages and returns, card against CPU;
 29. PPO train -> serve — ``repro_torch.launch.train.main --algo ppo``
                (pendulum, then cartpole; 8 members, PBT, ``--epochs 4``)
                counted as the train phase, its ms per iteration and busy
                share; then the checkpoint served through
                ``repro_torch.launch.serve.main`` (pendulum ``mean``,
                cartpole ``vote``), 3 ``pop_matmul`` launches a batch,
                answers against the plain ensemble;
 30. Fig. 2, PPO — the PPO arm at the SAC arm's dims, capped at 15 s;
 31. hopper2d — its two kernels against their plain versions at 8
                members x 4,096 envs, from states 50 random-action steps
                in (the count with a contact active logged), actions
                uniform in [-1.2, 1.2]: the raw step, one step and three
                chained at rtol=atol=2e-4; the vector env's whole step
                (time limit, auto-reset, accounting), one step and three
                chained from a state with every fifth env at t = 399 and
                every seventh torso fallen, every output equal to the bit
                but those named (at rtol=atol=2e-4); each timed by graph
                replay beside its plain version and its byte bound; then
                what limits them (registers, threads an env, occupancy,
                stack frame and spills from ptxas, LDL/STL from the SASS)
                and their times, and ``VecEnv.step``'s on its route and on
                the generic path, at 2,048, 8,192, 32,768 and 524,288
                envs, beside the kernel's before its redesign;
 32. fused epochs — ``run_env_loop(fused=True)``, one captured CUDA graph
                an epoch, against the eager loop from the same seed: TD3,
                SAC and PPO on hopper2d and DQN on cartpole with PBT, TD3
                with CEM, width (256, 256), N = 8, 256 envs a member, 2
                epochs of pbt_interval 4 with eval_every 2, the second
                under ``set_sync_debug_mode("error")``: state, hypers,
                buffers, env states, strategy state, fitness and lineage
                (bit for bit or not, logged), each capture's node count,
                capture time and private pool. Here and in phases 33,
                34, 39, 41 and 44 every hopper2d launch of a ``VecEnv``
                path must take the vector step's route (one launch a
                step: the wrapper's count by route), and each fused
                phase logs its graphs' node counts;
 33. acting engine — TD3 on hopper2d at 256, 1,024 and 4,096 envs a
                member (N = 8, 4 acting steps, 2 updates of B = 64, K = 8
                iterations with a host read each, median of 5 rounds with
                min and max): the eager loop, the fused epoch and
                ``policy_lag=1``, and at 4,096 envs ``chunk_steps=2`` bit
                for bit against unchunked; ms per iteration, env steps/s
                per member, the busy share, and at lag 1 the share of
                acting's kernel time that overlaps the update's;
 34. acting CLI — ``launch/train.py`` on hopper2d with ``--fused-epoch``
                (TD3), ``--chunk-steps 2`` (PPO) and ``--policy-lag 1``
                (TD3), counted, each checkpoint served through
                ``launch/serve.py`` against the plain ensemble; the
                lag-1 run's last checkpoint, saved with the next collect
                in flight, equal to the engine's state once the card has
                finished it;
 35. frontend parity — ``musicgen-medium`` and ``pixtral-12b`` at full
                width with 2 layers in float32, a 384-token sequence with
                random frame or patch embeddings: the serve step's
                prefill (last logits, every decode-state leaf), the
                stateless forward (every logit, pixtral's patches
                spliced) and ``lm_loss`` with its mask, card (kernels)
                against CPU, 2 ``flash_attention`` launches a pass; and
                pixtral's loss the same bits with the labels under its
                patches changed;
 36. frontend training — each through ``repro_torch.launch.train.main``
                at full width with its depth cut (``--num-layers``;
                musicgen 2 layers, N = 4; pixtral 1 layer, N = 2, its 256
                patch positions masked; ``--ckpt-every 0``): one
                ``pop_adam`` launch a step and no other kernel, evolves,
                finite losses (musicgen's ln 2048 exactly, its frames being
                zeros), tokens/s per member, the busy share, the peak of
                allocated memory under 70 GB; then ``pop_adam`` at the
                run's (N, P) timed beside its bound, the plain version and
                ``torch._fused_adamw_``;
 37. LM CEM — the chunked in-place refit and redraw over ``LMAgent``'s
                flat buffer against the whole-matrix forms, bit for bit
                (qwen2-0.5b at full width, 2 layers, N = 4); then
                ``--arch qwen2-0.5b --strategy cem`` at full size through
                the CLI (N = 4, evolves at steps 2 and 4): the bind and
                each evolve timed, the buffer at one address throughout,
                lineage all -1, one ``pop_adam`` launch a step, the peak
                of allocated memory under 70 GB;
 38. acting update kernels — ``pop_matmul`` (24 forwards and 12
                backwards) and ``pop_adam`` (actor and twin critic) at the
                acting engine's update batch, TD3 on hopper2d at N = 8, B
                = 64, timed beside their bounds, plain versions and
                library calls;
 39. RL resume — TD3 on hopper2d in fused epochs (N = 8, 256 envs a
                member): 2 epochs, a checkpoint, then a fresh trainer
                resumes and runs 2 more, against 4 uninterrupted epochs
                bit for bit (state, hypers, buffers, env states, the
                generator), and a resume after its capture refused; then
                the eager TD3 ``--fused-adam --fused-linear`` CLI on
                pendulum run twice on one ``--ckpt-dir`` against one run
                of twice the steps, its last checkpoint bit for bit;
 40. LM resume — qwen2-0.5b at full width, 2 layers, N = 2, through the
                CLI: 4 steps with checkpoints at 2 and 4, and the same 4
                steps resumed from step 2's checkpoint (``--resume
                auto``), equal at the update parity's tolerance; the
                seconds the loop was blocked by an asynchronous save (its
                ``ckpt`` rows) and by a blocking one, and the
                checkpoint's bytes;
 41. telemetry sink — the fused epoch (the acting engine's TD3 at 256,
                1,024 and 4,096 envs a member) with a strict
                ``JSONLSink`` attached from the trainer's construction:
                two epoch lengths captured with the sink live (the second
                while the writer copies the first epoch's rows), then
                replayed under ``set_sync_debug_mode("error")`` with the
                sink and without one: ms per iteration of each, and the
                logged metrics equal to the returned ones;
 42. serve telemetry — the RL serve CLI on phase 6's checkpoint and the LM serve CLI
                (qwen2-0.5b at full size) with ``--log-dir`` and ``--profile``: every
                row schema-valid (the port's copy of the JAX row schema,
                which ``tools/report.py --check`` applies; the tool
                itself imports the JAX package), the serve rows' p50
                beside a run without telemetry, and a Chrome trace that
                holds every kernel launch of its window (a session opened
                minutes after the process's previous one loses its first
                launches' kernels, ROADMAP §3 fault 8: ``start_profile``
                and ``stop_profile`` give it throwaway launches to lose);
 43. RL elastic — TD3 on pendulum at N = 8 (B = 256) saved with a fitness
                the phase sets, restored at 6 and at 12 members by
                ``restore_elastic``: the lineage computed from that
                fitness, every leaf (state, hypers, replay rings and
                counters, env states and episode accounting) gathered
                bit for bit, 2 more iterations with their ``pop_matmul``
                and ``pop_adam`` launches counted; the save, the restore
                and the first iteration timed; then the train CLI with
                ``--resize auto`` at both sizes (the lineage it prints,
                its launches) and ``--resize strict`` refused;
 44. fused elastic — the acting engine's fused TD3 on hopper2d (N = 8,
                256 envs a member) saved after 2 epochs, restored at 6
                and 12: 2 epochs captured after the restore against the
                eager loop, bit for bit, ``hopper2d`` launches counted;
 45. LM elastic — phase 40's step-2 checkpoint (qwen2-0.5b at full
                width, 2 layers, N = 2) resumed at 1 and 3 through the
                CLI with ``--resize auto``: the lineage it prints, every
                row bit for bit, the flat buffers kept, the gather's
                host seconds and the peak of allocated memory, one
                ``pop_adam`` step on the restored buffers against its
                plain version, then one step of the resumed trainer
                (one ``pop_adam`` launch in place); ``--resize strict``
                refused;
 46. DoubleBuffer — token and float batches to the card under
                ``set_sync_debug_mode("error")``, each equal to its host
                values;
 47. examples — ``repro_torch.examples.quickstart`` and ``.pbt_td3`` on
                the card, their launches counted. After phase 15 a line
                gives the LM train step's model FLOPs
                (``models.accounting``) and their share of the card's
                dense bf16 peak.
 48. islands CLI — the train CLI through ``python -m
                torch.distributed.run --standalone --nproc-per-node 1``
                (a world of one NCCL rank): TD3 on hopper2d at the repo's
                width, N = 8, 256 envs a member, ``--fused-adam
                --fused-linear``, one evolve, ``--backend islands`` and
                then ``sharded``, each against ``--backend vectorized``:
                the layout printed as one island over NCCL, the lineage
                and every checkpoint leaf equal (bit for bit counted, the
                rest at rtol 1e-4, atol 1e-6);
 49. islands ranks — the same TD3 population on two gloo ranks sharing
                cuda:0 (spawned; NCCL refuses two ranks on one GPU), 3
                iterations and an evolve whose parents are on rank 0 and
                children on rank 1, against one rank: each rank's
                ``pop_matmul`` (by route), ``pop_adam`` and ``hopper2d``
                launches equal to the one rank's (a launch takes all the
                members a rank holds), the exchange bit for bit, the
                state at rtol 1e-4, atol 1e-6, the checkpoint rank 0
                wrote equal to the ranks' rows bit for bit; ms per
                iteration with one and two ranks on the one card (no
                speed-up claimed), the exchange's seconds and bytes;
 50. islands elastic — that checkpoint of 8 members from 2 ranks
                restored at 6 on one rank and at 12 on two: the lineage
                from its fitness, every rank's rows bit for bit, one more
                iteration each;
 51. LM islands — qwen2-0.5b at full width, 2 layers, float32, N = 4
                over two gloo ranks on the card: 2 steps and an evolve
                that copies member 0 (rank 0) into member 3 (rank 1), the
                copy bit for bit (digests), the flat buffers kept, each
                rank's rows within the LM update rule of the one-rank run;
                the exchange's seconds and bytes and the peak of
                allocated memory per rank;
 52. DP reduction — ``make_dp_update`` over two gloo ranks on the card,
                plain and int8, on the JAX test's problem: convergence,
                int8 within 0.1 of plain, the wire bytes of each and the
                ms of one reduction of a 4 Mi-element gradient (gloo goes
                through the host). Phases 49, 50 and 52 share one spawn
                of the two ranks.
 53-55. model-sharded members — qwen2-0.5b and rwkv6-1.6b at full width
                over one island of model 2 (two gloo ranks sharing the
                card) against the one-rank run, the exchange and the
                checkpoints across model widths, qwen3-8b's memory a rank;
                after the bf16 forward each rank serves the prompt at
                model 2 with its part of the decode state (the heads
                layout) and 8 decode steps, held as the forward is to the
                whole member's decode, the state exactly the layout
                rule's part;
 56. model-sharded MoE, MLA and Mamba2 members — qwen3-moe-30b-a3b (1
                layer), deepseek-v2-lite-16b (its dense layer and one MoE
                layer) and zamba2-7b (2 Mamba2 layers under the shared
                block) at full width, float32, N = 2 over one island of
                model 2: the one-rank reference first, in this process
                (its routing recorded), then the two ranks (the routing
                replayed), each held at up to 4,096 sampled elements a
                leaf and member by the LM update rule, 1 ``pop_adam`` a
                rank and step; member 0's bf16 forward on the ranks' parts
                (``flash_attention`` and ``ssd`` at a rank's heads) within
                ``BF16_TP_RMS_RATIO`` of the one-rank forward's error;
                zamba2 (SSD heads, conv channels, the shared block's KV
                heads) and deepseek (MLA's latent cache cut on its
                sequence, combined by log-sum-exp) served at model 2 with
                8 decode steps, held as phase 53's decode (deepseek's
                routing replayed); the kernels at those shapes against
                their plain versions, timed.
 57-59. CEM over islands and model-sharded members; the RL ensemble
                served over ranks.
 60. the dry run's cell — qwen2-0.5b x decode_32k on a 1 x 1 mesh
                reckoned by ``launch.dryrun.build_cell`` on the meta
                device, then allocated (a 51.5 GB KV cache) and stepped
                on the card: the reckoned argument bytes equal the bytes
                allocated; the reckoned peak and ``t_memory`` printed
                beside ``max_memory_allocated`` and 5 timed steps.

A captured graph's kernel launches are counted as its captured launches
times its replays (the wrappers' Python counts do not see a replay).

The last lines are ``{"fig2": ...}``, ``{"lm_train": ...}``,
``{"shared": ...}``, ``{"fig4": ...}``, ``{"sac_dqn": ...}``,
``{"fig2_sac": ...}``, ``{"ppo": ...}``, ``{"acting": ...}``,
``{"frontends": ...}``, ``{"lm_cem": ...}``, ``{"slice15": ...}``,
``{"slice16": ...}``, ``{"slice18": ...}`` (with the whole run's
seconds), ``{"slice19": ...}``, ``{"slice20": ...}``, ``{"slice21":
...}`` and ``{"slice22": ...}`` lines, the card's
``nvidia-smi`` name and power limit, one JSON line with every kernel's
numbers, and ``{"ok": true, "device": ...}``.
Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# fp32 sums taken in another order than the plain version's
TOL = dict(rtol=1e-5, atol=1e-5)
# pow, sqrt and division contract differently in the Triton kernel
ADAM_TOL = dict(rtol=1e-5, atol=1e-6)
# fp32 sums of 256 terms in another order, times the activation's
# derivative
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# the update's gradients at step 1; the parameters after 4 steps, where
# Adam's normalised step can turn a 1e-6 gradient difference into up to lr
STEP1_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAMS_AFTER_4_ATOL = 1e-4
# the LM update's step p - p' is held at STEP1_GRAD_TOL where the gradient
# that took it is above the gradients' atol in both steps; the check must
# reject a learning rate this much off (its share past 1)
LM_STEP_GRAD_FLOOR = STEP1_GRAD_TOL["atol"]
LM_WRONG_LR = 1.01
# wkv6 / ssd against their chunked plain versions: fp32 sums over the head
# and the chunk in another order (tests/test_kernels.py's fp32 tolerance)
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
# flash_attention against its plain version: float32 sums over D and the
# keys in another order (tests/test_kernels.py's float32 tolerance); in
# bf16 the kernel rounds unnormalised probabilities, the plain version
# normalised ones, and both round the output (bf16 keeps 8 bits)
FLASH_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# (B, H, Hkv, S, D) of one served prefill's attention, bf16, per config
FLASH_SHAPES = {"qwen3-8b": (4, 32, 8, 512, 128),
                "qwen2-0.5b": (4, 14, 2, 512, 64),
                "zamba2-7b": (4, 32, 32, 512, 112),
                "gemma-7b": (4, 16, 16, 512, 256),
                "qwen3-moe-30b-a3b": (4, 32, 4, 512, 128),
                # slice 14: musicgen's MHA at D = 64 (pixtral's shape is
                # qwen3-8b's: 32 heads over 8 of 128)
                "musicgen-medium": (4, 24, 24, 512, 64)}
# the LM path at full width, card (kernels, cuBLAS) against CPU (plain
# versions): fp32 sums of up to 24,576 terms in other orders, through 2
# and 7 layers
PATH_TOL = dict(rtol=1e-3, atol=1e-3)
PARITY_PROMPT = 256
# the dense attention archs of the LM parity phase
DENSE = ("qwen2-0.5b", "qwen3-8b", "qwen2-1.5b", "gemma-7b")
# slice 12: the mixture-of-experts archs (qwen3-moe's GQA attention takes
# the flash kernel, deepseek's MLA and every MoE layer compute in plain
# PyTorch, as the JAX package computes them outside its kernels)
MOE = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b")
# the LM parity phase's archs: (arch, layers, kernel launches of the
# float32 prefill)
LM_PARITY_ARCHS = (("rwkv6-1.6b", 2, {"wkv6": 2}),
                   ("zamba2-7b", 7, {"ssd": 7, "flash_attention": 2}),
                   ("qwen2-0.5b", 2, {"flash_attention": 2}),
                   ("qwen3-8b", 2, {"flash_attention": 2}),
                   ("qwen2-1.5b", 2, {"flash_attention": 2}),
                   ("gemma-7b", 2, {"flash_attention": 2}),
                   ("qwen3-moe-30b-a3b", 2, {"flash_attention": 2}),
                   ("deepseek-v2-lite-16b", 2, {}))
# the LM serving runs: 4 prompts of 512 tokens, 8 new tokens each (32
# before slice 21: the decode, host-bound, is the served phases' largest
# part, and a quarter of it keeps the whole script in its time limit); each
# arch with its kernel launches of one served run
LM_SERVE = dict(batch=4, prompt_len=512, tokens=8)
LM_SERVE_ARCHS = (("qwen2-0.5b", {"flash_attention": 24}),
                  ("qwen3-8b", {"flash_attention": 36}),
                  ("rwkv6-1.6b", {"wkv6": 24}),
                  ("zamba2-7b", {"ssd": 81, "flash_attention": 14}),
                  ("qwen3-moe-30b-a3b", {"flash_attention": 48}),
                  ("deepseek-v2-lite-16b", {}),
                  ("musicgen-medium", {"flash_attention": 48}),
                  ("pixtral-12b", {"flash_attention": 40}))
# the H100 SXM's published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32
# FLOP/s outside the tensor cores, dense bf16 FLOP/s on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
# slice 8: LM population training at full width (qwen2-0.5b,
# arXiv:2407.10671: 494,032,768 parameters a member), its update card ==
# CPU at 2 layers, the LM CLI at .smoke() width, and the paper's Fig. 2
# unit (TD3, the repo's width)
LM_PARAMS = 494_032_768
LM_TRAIN = dict(arch="qwen2-0.5b", population=4, batch=4, seq_len=512,
                steps=4, pbt_interval=2)
LM_PEAK_LIMIT = 70e9          # bytes allocated at most in the LM train phase
LM_UPDATE = dict(arch="qwen2-0.5b", population=2, batch=2, seq_len=64,
                 steps=2)
# slice 12: the same update parity for deepseek-v2-lite-16b at full width
# with 2 layers (its dense first layer and one MoE layer), about 1.03 B
# parameters a member
LM_UPDATE_MOE = dict(LM_UPDATE, arch="deepseek-v2-lite-16b")
LM_CLI = ["--arch", "qwen2-0.5b", "--smoke", "--population", "2", "--steps",
          "4", "--pbt-interval", "2", "--batch", "2", "--seq-len", "64"]
# pop_adam at the LM's flat size, and at one past the old grid's limit of
# 65,535 blocks of 4096 on its second axis
POP_ADAM_LM = ((4, LM_PARAMS), (4, 2 ** 28 + 1))
# Fig. 2's unit: N = 1, 8, 32 at B = 256, 8 chained update steps a call
# (32 before slice 21: the sequential arm's N = 32 calls were the largest
# part of the three arms' 96 s, and a quarter of them keeps the whole
# script in its time limit; a call's ms per member-update-step is the
# figure)
FIG2 = dict(sizes=(1, 8, 32), batch=256, num_steps=8)
# the train CLI's LM hyper space (src/repro/launch/train.py:241-251)
LM_HYPER_SPACE = dict(log_uniform=(("lr_scale", 0.1, 10.0),
                                   ("weight_decay", 1e-3, 0.3)),
                      uniform=(("warmup_frac", 0.01, 0.25),))
# the port's slice that last redesigned each kernel (PERF.md keeps their
# times before it)
REDESIGNED_IN = {"pop_matmul": "slice 5", "flash_attention": "slice 5",
                 "ssd": "slice 6", "wkv6": "slice 7",
                 "hopper2d": "slice 17"}
# the backward check of the LM parity phase: gradients of mean(logits * w)
# through lm.forward at .smoke() width, card (plain nn forms, cuBLAS)
# against CPU: fp32 sums in other orders through up to 8 layers and back;
# per leaf rtol 1e-4 and an atol of 5e-5 times the leaf's largest
# gradient (tests/test_torch_autograd.py's tolerance against jax.grad)
BACKWARD_RTOL, BACKWARD_ATOL_OF_MAX = 1e-4, 5e-5
BACKWARD_SEQ = 32
SEED = 0
POPULATION = 8
ENSEMBLE = 4
BATCH = 256
REQUESTS = 64
# the training entry point's flags: 8 members at the repo's TD3 width,
# the TD3 paper's batch of 256; 22 iterations, so the last checkpoint
# follows an evaluation after the evolve at 20 and carries a fitness
TRAIN = dict(steps=22, pbt_interval=10, eval_every=2, num_envs=8,
             collect_steps=32, updates_per_iter=32, batch=256)
EVAL_ENVS, EVAL_STEPS = 4, 200     # the engine's evaluator: envs, steps
# (K, M, activation) of the training path's layers, and how many of the
# 24 forward launches of one update step each takes
ACTOR_LAYERS = ((3, 256, "relu"), (256, 256, "relu"), (256, 1, "tanh"))
CRITIC_LAYERS = ((4, 256, "relu"), (256, 256, "relu"), (256, 1, "none"))
# pop_matmul launches of each route in one served batch (the actor's
# 256-wide layers tiled, its M=1 head narrow) and in one update step
SERVED_BATCH_ROUTES = {"tiled": 2, "narrow": 1}
UPDATE_STEP_ROUTES = {"tiled": 16, "narrow": 8}
# slice 9: the shared-critic update (§4.2) at the width of the paper's
# Fig. 4 benchmark (benchmarks/shared_critic.py: obs 17, act 6, B=256),
# half the members training and a constant DvD coefficient on a probe of
# 20 states; its policies' layers, and the pop_matmul launches of each
# route one step makes with the DvD term (without it, 2/3 of them)
SHARED = dict(obs=17, act=6, population=8, batch=256, train_frac=0.5,
              dvd_coef=0.5, probe=20, steps=4)
SHARED_ACTOR_LAYERS = ((17, 256, "relu"), (256, 256, "relu"),
                       (256, 6, "tanh"))
SHARED_STEP_ROUTES = {"tiled": 6, "narrow": 3}
FIG4 = dict(sizes=(2, 4, 8, 16), batch=256, reps=7)
# the examples' runs: CEM-RL's defaults (N=10) for 3 iterations; DvD's
# (N=5, 32 updates an iteration, dvd_period 400) for 8, which passes
# update step 200, where the diversity coefficient turns on
CEMRL_RUN = dict(population=10, iters=3)
DVD_RUN = dict(population=5, iters=8)
# slice 10: SAC on pendulum (obs 3, act 1) and DQN on cartpole (obs 4, 2
# actions) at the repo's width, N=8, B=256. SAC's actor (its head M =
# 2 act: mean and log std) and DQN's Q-network; per update step SAC makes
# TD3's 24 pop_matmul launches (16 tiled, 8 narrow) and 3 pop_adam
# (critic, actor, log_alpha at P=1 a member), DQN 6 (4 tiled, 2 narrow)
# and 1; a served batch is 3 launches (2 tiled, 1 narrow) for either
SAC_ACTOR_LAYERS = ((3, 256, "relu"), (256, 256, "relu"), (256, 2, "none"))
DQN_LAYERS = ((4, 256, "relu"), (256, 256, "relu"), (256, 2, "none"))
SAC_DQN = {"sac": dict(env="pendulum", obs=3, act=1, mode="mean",
                       step_routes={"tiled": 16, "narrow": 8}, adam=3),
           "dqn": dict(env="cartpole", obs=4, act=2, mode="vote",
                       step_routes={"tiled": 4, "narrow": 2}, adam=1)}
# the (K, M) pairs of the slice's nets: first layers of K 2, 3, 4 and 6
# (mountain_car's, pendulum's, cartpole's and acrobot's obs, and a
# critic's obs and action), SAC's gaussian head (M = 2 act) and DQN's
# heads (M = 2 and 3, the narrow route)
SAC_DQN_KM = ((2, 256), (3, 256), (4, 256), (6, 256), (256, 2), (256, 3))
# DQN's members start near its target sync (every 100 steps of a member's
# own clock, read after the increment): a 4-step chain syncs the first
# four at different steps and the rest never
DQN_START_STEPS = (97, 98, 99, 96, 50, 0, 10, 20)
# the training entry point for SAC and DQN: 8 members, 5 iterations of 32
# updates, PBT every 2, an evaluation every iteration (so the last
# checkpoint, after the evolve at 4, carries a fitness)
SAC_DQN_TRAIN = dict(steps=5, pbt_interval=2, eval_every=1, num_envs=8,
                     collect_steps=32, updates_per_iter=32, batch=256)
# DQN's Atari torso, card (cuDNN's F.conv2d, TF32 off) against CPU: 32
# frames of 84x84x4, 6 actions; fp32 sums of 256 to 3,136 terms in other
# orders through three convolutions and two dense layers
TORSO = dict(frames=32, actions=6)
TORSO_TOL = dict(rtol=1e-4, atol=1e-5)
# Fig. 2's SAC arm: the median of 3 calls a cell, unless the arm would
# pass its limit (FIG2_ARMS); its projection allows for the host's spread between calls
# (a cell's slowest call 1.15x its median in PR 22's run 1)
FIG2_REPS = 3
FIG2_HOST_SPREAD = 1.15
# slice 11: PPO on pendulum (obs 3, act 1) and cartpole (obs 4, 2
# actions) at the repo's width, N=8, minibatches of 256. A step runs the
# actor's 3 layers (a tanh mean, or the logits) and the value head's 3, all
# differentiated: 6 pop_matmul launches (4 tiled, 2 narrow) and 1 pop_adam
# over the member's whole {actor, critic[, log_std]} tree; an acting step
# is the same 6 forwards, a GAE call and an evaluation or served batch 3
PPO = {"pendulum": dict(obs=3, act=1, discrete=False, mode="mean"),
       "cartpole": dict(obs=4, act=2, discrete=True, mode="vote")}
PPO_STEP_ROUTES = {"tiled": 4, "narrow": 2}
# the (K, M) pairs new to the slice: the first layers of obs 3 and 4, the
# value head and cartpole's logits
PPO_KM = ((3, 256), (4, 256), (256, 1), (256, 2))
# the training entry point for PPO: 8 members, 5 iterations of a rollout
# of 64 steps x 8 envs in minibatches of 256 for 4 epochs (8 chained
# updates), PBT every 2, an evaluation every iteration
PPO_TRAIN = dict(steps=5, pbt_interval=2, eval_every=1, num_envs=8,
                 collect_steps=64, batch=256, epochs=4)
# the GAE phase: card against CPU on the same rollout (the same float32
# recursion); half the envs start 20 steps before cartpole's time limit,
# so the rollout holds truncations beside its terminations
GAE_TOL = dict(rtol=1e-5, atol=1e-6)
# Fig. 2's arms beside the TD3 one: the seconds each may take with
# FIG2_REPS calls a cell, and the pop_matmul and pop_adam launches of one
# vectorized update step
FIG2_ARMS = {"sac": dict(limit_s=25.0, launches=(24, 3)),
             "ppo": dict(limit_s=15.0, launches=(6, 1))}
# slice 13, the acting engine. hopper2d's kernels against their plain
# versions at 8 members x 4,096 envs, from states 50 random-action steps in, with
# actions past the [-1, 1] clip, at the tolerance at which the JAX package
# holds its own step to the float64 oracle
HOPPER2D_KERNEL = dict(members=8, envs=4096, warm_steps=50,
                       action_limit=1.2)
# what limits it: its time at the acting engine's 256, 1,024 and 4,096
# envs a member (N = 8) and at 16 times the largest (524,288 envs)
HOPPER2D_SIZES = (256, 1024, 4096, 65536)
# the kernel before its redesign (one thread an env, the tables in
# __constant__ memory, the VecEnv step's tail as tensor code): its ptxas
# figures, its SASS's local-memory instructions, and the raw step's and
# VecEnv.step's us by graph replay at 8 x HOPPER2D_SIZES envs, from
# hopper2d_limits on an NVIDIA H100 80GB HBM3 at 700 W
HOPPER2D_BEFORE = dict(
    registers=62, stack_frame_bytes=208, ldl_stl=231,
    raw_us={2048: 13.118, 8192: 13.571, 32768: 27.924, 524288: 340.365},
    generic_step_us={2048: 96.295, 8192: 101.984, 32768: 134.407,
                     524288: 765.672})
HOPPER2D_TOL = dict(rtol=2e-4, atol=2e-4)
# one env of one launch: 27 float32 read (pose, velocities, action), 36
# float32 and a bool written (pose, velocities, observation, reward,
# termination); and its float operations, counted from csrc/hopper2d.cu
# with sin, cos and tanh as one each: 396 a substep (16 gravity and
# trigonometry, 3 joints of 60, 5 contacts of 28, 60 of integration),
# and 38 outside the substeps (clip, inertias, observation, reward,
# termination)
HOPPER2D_BYTES = 27 * 4 + 36 * 4 + 1
# one env of the vector env's whole step (``hopper2d_vec_step``): read the
# state (24 floats and t), the action (3), the reset draws (12) and the 6
# accounting values; write the state and t, the observation after and
# before the reset (22), the reward and the transition's two flags as
# floats, done and truncated as bytes, and the 6 accounting values
HOPPER2D_VEC_BYTES = (25 + 3 + 12 + 6) * 4 + (25 + 22 + 3 + 6) * 4 + 2
HOPPER2D_OPS = 5 * 396 + 38
# the fused epoch, captured vs eager: PBT at the repo's width, N = 8, 256
# envs a member, 2 epochs of pbt_interval 4 with eval_every 2; the JAX
# sweep's collect and update shape (4 acting steps, 2 updates of B = 64;
# PPO 2 epochs of 256-transition minibatches); 50-step evaluations of 16
# envs. The match is expected bit for bit; FUSED_TOL is what is held
FUSED = dict(population=8, num_envs=256, pbt_interval=4, eval_every=2,
             collect_steps=4, updates=2, batch=64, ppo_batch=256,
             ppo_epochs=2, eval_envs=16, eval_steps=50)
FUSED_TOL = dict(rtol=1e-5, atol=1e-5)
# the fused trainer's epochs: the capture, a replay, an eager epoch, and a
# replay from the eager epoch's state (copied into the static inputs)
FUSED_SEQUENCE = ("fused", "fused", "eager", "fused")
FUSED_RUNS = (("td3", "hopper2d", "pbt"), ("sac", "hopper2d", "pbt"),
              ("ppo", "hopper2d", "pbt"), ("dqn", "cartpole", "pbt"),
              ("td3", "hopper2d", "cem"))
# the acting engine at GPU-sim scale: benchmarks/actor_loop.py's overlap
# sweep (TD3 on hopper2d, 4 acting steps, 2 updates of B = 64, K = 8
# iterations with a host read each, the median of 5 rounds) at the repo's
# width and N = 8
ACTING = dict(population=8, envs=(256, 1024, 4096), collect_steps=4,
              updates=2, batch=64, iters=8, rounds=5, chunk_steps=2)
# the train CLI with each acting-engine flag on hopper2d, then served
ACTING_CLI = dict(
    steps=4, pbt_interval=2, eval_every=2, num_envs=256, collect_steps=4,
    requests=8,
    runs={"td3_fused_epoch": ("td3", ["--fused-epoch", "--updates-per-iter",
                                      "2", "--batch", "64"], "mean"),
          "ppo_chunk_steps": ("ppo", ["--chunk-steps", "2", "--batch", "256",
                                      "--epochs", "2"], "mean"),
          "td3_policy_lag": ("td3", ["--policy-lag", "1",
                                     "--updates-per-iter", "2", "--batch",
                                     "64"], "mean")})
# slice 14: the frontend archs (musicgen-medium: audio frames in place of
# an embedding table; pixtral-12b: 256 vision-patch positions spliced over
# the stateless form's first positions, their labels masked), served at
# full size in LM_SERVE_ARCHS, their parity at full width with 2 layers
FRONTENDS = ("musicgen-medium", "pixtral-12b")
FRONTEND_PARITY_LAYERS = 2
# pixtral's 256 patch positions and 128 text tokens: at 256 tokens every
# label would be masked and the loss 0
FRONTEND_PARITY_SEQ = 384
# trained through the CLI at full width with their depth cut: float32
# masters, Adam's moments and the gradients' buffer take 16 B a parameter
# and member, so pixtral's 1.61 B a member at 1 layer and N = 2 take about
# 52 GB of the 70 allowed
FRONTEND_TRAIN = {"musicgen-medium": dict(population=4, layers=2, batch=4),
                  "pixtral-12b": dict(population=2, layers=1, batch=1)}
FRONTEND_TRAIN_RUN = dict(steps=4, pbt_interval=2, seq_len=512)
# CEM over qwen2-0.5b's parameters at full size through the CLI (evolves
# at steps 2 and 4), and its chunked in-place forms against the
# whole-matrix ones at full width with 2 layers
LM_CEM = dict(arch="qwen2-0.5b", population=4, batch=4, seq_len=512,
              steps=4, pbt_interval=2)
LM_CEM_PARITY_LAYERS = 2
# the acting engine's update batch: TD3 on hopper2d (obs 11, act 3) at
# the repo's width, N = 8, B = 64
HOPPER_ACTOR_LAYERS = ((11, 256, "relu"), (256, 256, "relu"),
                       (256, 3, "tanh"))
HOPPER_CRITIC_LAYERS = ((14, 256, "relu"), (256, 256, "relu"),
                        (256, 1, "none"))
# slice 15: checkpoint resume and run telemetry. The eager TD3 CLI on
# pendulum at the repo's width (N = 8), run twice for 4 iterations on one
# --ckpt-dir against once for 8 (PBT every 2, so the checkpoint at 4
# follows an evolve and the fitness window is empty there)
RESUME_CLI = dict(steps=4, pbt_interval=2, eval_every=2, num_envs=8,
                  collect_steps=32, updates=32)
# qwen2-0.5b at full width with its depth cut to 2 layers (about 166 M
# parameters a member, 136 M of them the embedding), N = 2: 4 steps with a
# checkpoint every 2 (about 4 GB of main tree: the parameters and both
# Adam moments of the 2 members; with the actors 5.3 GB), resumed from
# the first; held at the LM update parity's tolerance. N was 4 before
# slice 21: the checkpoints' bytes, written three times and read three
# times with phase 45, were a tenth of the run, and half of them keeps
# the whole script in its time limit
LM_RESUME = dict(arch="qwen2-0.5b", layers=2, population=2, batch=4,
                 seq_len=512, steps=4, pbt_interval=2, ckpt_every=2)
LM_RESUME_TOL = dict(rtol=1e-4, atol=1e-6)
# the fused epoch with and without a live JSONL sink: ACTING's shape,
# this many rounds of each, alternating
SINK = dict(rounds=5)
# the RL serve CLI with telemetry: the profiler's window in request
# batches
SERVE_TELEMETRY = dict(profile_iters=16)
# slice 16: elastic population resize. TD3 on pendulum at the repo's width
# (N = 8, B = 256, RESUME_CLI's collect and update shape, no evolve),
# saved after 2 iterations with this fitness (distinct values, so the
# lineage is the fitness's order) and resumed at 6 and at 12 members; the
# fused TD3 on hopper2d (FUSED's shape) saved after 2 epochs with the same
# fitness and resumed at the same sizes
ELASTIC = dict(population=8, sizes=(6, 12), iters=2,
               fitness=(5.0, 1.0, 7.0, 3.0, 8.0, 2.0, 6.0, 4.0))
# the LM population resumed at these sizes from phase 40's step-2
# checkpoint (N = 2), one step each through the CLI: shrunk and grown
LM_ELASTIC_SIZES = (1, 3)
# DoubleBuffer on the card: this many batches of the LM train phase's
# token shape, with a float leaf beside them
DOUBLE_BUFFER = dict(batches=4, floats=(256, 64))
# the two examples on the card: quickstart's iterations; pbt_td3's
# population and iterations (its default shape otherwise)
EXAMPLES = dict(quickstart_iters=3, pbt_td3_population=8, pbt_td3_iters=4)
# slice 18: population islands over ranks. TD3 on hopper2d at the repo's
# width, N = 8, 256 envs a member, 4 acting steps and 2 updates of B = 256
# an iteration; ISLANDS_FITNESS puts the two worst members (6 and 7, the
# second rank's) under the two best (0 and 1, the first rank's), so the
# evolve copies across ranks. Two gloo ranks share cuda:0 (NCCL refuses
# two ranks on one GPU); the CLI runs a world of one NCCL rank
ISLANDS = dict(population=8, num_envs=256, collect_steps=4, updates=2,
               batch=256, timeout=420)
ISLANDS_FITNESS = (8.0, 7.0, 6.0, 5.0, 4.0, 3.0, 2.0, 1.0)
ISLANDS_CLI = dict(steps=3, pbt_interval=2, timeout=240)
# qwen2-0.5b at full width with 2 layers, float32, N = 4 over two ranks
# (2 members each, about 2.7 GB of parameters and moments a member)
LM_ISLANDS = dict(arch="qwen2-0.5b", layers=2, population=4, batch=2,
                  seq_len=128, timeout=420)
# slice 19: model-sharded members over an island's model axis, on gloo
# ranks sharing cuda:0. 53: each arch at full width with 2 layers, float32,
# (arch, N) over one island of model 2, 2 steps against the one-rank run,
# then member 0 in bf16 forward without autograd on 4 x 512 tokens (the
# kernels at a rank's local heads); 54: the exchange and the checkpoints
# on 2 islands x model 2 (4 ranks) of the repo's RWKV6 test config; 55:
# qwen3-8b at full width, 1 layer, N = 2, each rank's memory
MP = dict(parity=(("qwen2-0.5b", 4), ("rwkv6-1.6b", 2)), layers=2,
          batch=2, seq_len=128, forward_batch=4, forward_len=512,
          timeout=900)
MP_ISLANDS = dict(arch="rwkv6-test", population=4, batch=2, seq_len=64)
MP_MEMORY = dict(arch="qwen3-8b", layers=1, population=2, batch=1,
                 seq_len=512)
# slice 20: 56, model-sharded members of the MoE, MLA and Mamba2 families,
# each at full width, float32, N = 2 over one island of model 2 (2 gloo
# ranks sharing cuda:0): the update on a seq_len of zamba2's chunk, up to
# `samples` elements of each leaf a member held against the one-rank run,
# then member 0's bf16 forward without autograd on 4 x 512 tokens, whose
# kernels launch at a rank's heads as `launches` says
MP_FAMILIES = dict(
    archs=(("qwen3-moe-30b-a3b", 1), ("deepseek-v2-lite-16b", 2),
           ("zamba2-7b", 2)),
    population=2, batch=2, seq_len=256, forward_batch=4, forward_len=512,
    samples=4096, timeout=600,
    launches={"qwen3-moe-30b-a3b": {"flash_attention": 1, "ssd": 0},
              "deepseek-v2-lite-16b": {"flash_attention": 0, "ssd": 0},
              "zamba2-7b": {"flash_attention": 1, "ssd": 2}})
# the bf16 forward on a rank's parts against the one-rank forward, both
# measured from the float32 one-rank forward: a bf16 forward strays from
# it by more than any fixed tolerance would allow between the two, and
# each row-parallel product rounds its two partial sums to bf16 before
# they are added (in float32). The sharded forward's RMS error may be at
# most this multiple of the one-rank forward's (phase 53 prints both)
BF16_TP_RMS_RATIO = 1.25
# slice 22: a decode state over the model axis. After phases 53's and 56's
# bf16 forwards, each rank serves the same 4 x 512-token prompt into a
# cache of prompt + `tokens` positions and then `tokens` decode steps of
# random tokens at model 2 (qwen2-0.5b and rwkv6-1.6b in 53; zamba2-7b and
# deepseek-v2-lite-16b in 56), its state the layout rule's part; the
# logits' RMS error from the float32 one-rank decode is held as the
# forward's (BF16_TP_RMS_RATIO)
MP_DECODE = dict(tokens=8, archs_56=("deepseek-v2-lite-16b", "zamba2-7b"))
# slice 22, phase 60: the dry run's cell one H100 holds, reckoned on the
# meta device and then allocated and stepped on the card
DRYRUN_CELL = dict(arch="qwen2-0.5b", shape="decode_32k", steps=5)
# the data-parallel reduction on the JAX test's problem
# (tests/test_dp_compression.py: convergence within 0.05, int8 within 0.1
# of plain), and the wire bytes and ms of one reduction of a gradient of
# this many fp32 elements
DP = dict(steps=300, converge_atol=0.05, plain_atol=0.1,
          grad_elems=1 << 22)
# slice 21. 57: CEM over islands, TD3 on pendulum at the repo's width,
# N = 8 (2 islands of 4 over two gloo ranks on cuda:0), bind and 4
# iterations with an evaluation and an evolve every 2; 58: CEM over
# qwen2-0.5b at full width, 2 layers, fp32, N = 4, at islands x model 1 x 2
# and 2 x 1, bind, 2 steps on the given fitness and an evolve (elites
# members 1 and 3, on both islands at 2 x 1); 59: the RL ensemble served
# over two ranks (`serve --islands`): case -> (algo, env, mode, ensemble),
# and the newer checkpoint's fitness
CEM_ISLANDS = dict(population=8, num_envs=8, collect_steps=32, updates=2,
                   batch=256, iters=4, pbt_interval=2, cli_iters=2,
                   timeout=420)
LM_CEM_ISLANDS = dict(arch="qwen2-0.5b", layers=2, population=4, batch=2,
                      seq_len=128, fitness=(1.0, 4.0, 2.0, 3.0),
                      timeout=600)
SERVE_ISLANDS = dict(cases={"td3_mean": ("td3", "pendulum", "mean", 8),
                            "td3_best": ("td3", "pendulum", "best", 8),
                            "dqn_vote": ("dqn", "cartpole", "vote", 4)},
                     requests=32, timeout=420,
                     newer_fitness=(5.0, -1.0, 0.0, 9.0, 2.0, 8.0, 1.0, 7.0))


def log(msg: str):
    """A line of the run's log, led by the seconds since the script was
    imported in this process (a rank of a session imports it anew)."""
    print(f"[smoke {time.perf_counter() - T_START:7.1f}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def reset_counts(*wrappers):
    """Set each kernel wrapper's launch count, and its count by route where
    it keeps one, to 0."""
    for fn in wrappers:
        fn.launches = 0
        for route in getattr(fn, "launches_by_route", {}):
            fn.launches_by_route[route] = 0


def hopper2d_counts():
    """hopper2d's launches, all routes, and those of the vector env's
    one-launch route."""
    from repro_torch.kernels.hopper2d import hopper2d_step
    return {"hopper2d": hopper2d_step.launches,
            "hopper2d_vec": hopper2d_step.launches_by_route["vec"]}


def reset_hopper2d_counts():
    from repro_torch.kernels.hopper2d import hopper2d_step
    hopper2d_step.launches = 0
    hopper2d_step.launches_by_route = dict.fromkeys(
        hopper2d_step.launches_by_route, 0)


def expect_vec_route(what, launches):
    """A VecEnv path on hopper2d: launched hopper2d, every launch on the
    vector env's route (none on the raw step and the generic tail)."""
    if not launches["hopper2d"] or \
            launches["hopper2d_vec"] != launches["hopper2d"]:
        raise AssertionError(f"{what}: {launches['hopper2d']} hopper2d "
                             f"launches, {launches['hopper2d_vec']} of them "
                             f"on the vec route")


def pop_matmul_routes(n, bsz, layers):
    """Launches of each pop_matmul route for ``layers`` of (K, M, count),
    by the wrapper's own rule."""
    from repro_torch.kernels.pop_matmul import ROUTES, _route

    out = dict.fromkeys(ROUTES, 0)
    for k, m, count in layers:
        out[_route(n, bsz, k, m)] += count
    return out


def scaled(routes, factor):
    return {k: v * factor for k, v in routes.items()}


def added(*routes):
    return {k: sum(r[k] for r in routes) for k in routes[0]}


def ptxas_figures(report):
    """{kernel: (registers, spill store bytes, spill load bytes, stack
    frame bytes)} from the ``-Xptxas -v`` lines of one nvcc build."""
    out, entry, props, spills = {}, None, None, {}
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, props = m.group(1), None
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry and props in (None, entry):
            spills[entry] = (int(m.group(2)), int(m.group(3)),
                             int(m.group(1)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = (int(m.group(1)),) + spills.get(entry, (0, 0, 0))
    return out


def kernel_labels(mangled):
    """{mangled kernel name: short name}, e.g. flash_mma_bf16<128>: the
    toolkit's cu++filt without parameters, scope and casts."""
    from repro_torch.kernels import build

    names = sorted(set(mangled))
    filt = Path(build._nvcc()).parent / "cu++filt"
    out = subprocess.run([str(filt), "-p", *names], capture_output=True,
                         stdin=subprocess.DEVNULL, text=True, check=True,
                         timeout=60).stdout.split("\n")
    if len(out) < len(names):
        raise RuntimeError(f"cu++filt gave {out} for {names}")
    return {m: re.sub(r"^.*::|\((?:int|bool)\)", "", d.strip())
            for m, d in zip(names, out)}


def sass_counts(library, pattern):
    """{kernel: count of the instructions matching ``pattern``} in a
    built library's SASS, read with the toolkit's cuobjdump."""
    from repro_torch.kernels import build

    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts = {}
    for chunk in sass.split("Function : ")[1:]:
        counts[chunk.split("\n", 1)[0].strip()] = len(
            re.findall(pattern, chunk))
    return counts


def sass_hmma_counts(library):
    """{kernel: count of HMMA (tensor-core) instructions} in a built
    library's SASS."""
    return sass_counts(library, r"HMMA")


# ------------------------------------------------------------------ timing
def graph_ms(fn, reps: int = 50, iters: int = 20, generator=None) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured into one
    CUDA graph, replayed ``iters`` times between CUDA events. Host launch
    overhead is left out; inputs stay in L2, as the serving path's
    weights do between batches. A CUDA ``generator`` that ``fn`` draws
    from is registered with the graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def eager_ms(fn, iters: int = 200) -> float:
    """Time of one eager ``fn()`` call, host launch overhead included."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def events_ms(fn, reps: int = 5) -> float:
    """Device time of one eager ``fn()`` call between CUDA events, the
    mean of ``reps`` calls after one warm call: for launches too large
    for L2 (cold by construction) or for a graph's private pool."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def tol_share(got, want, tol) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 within ``tol``,
    as ``torch.testing.assert_close`` judges it."""
    return ((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())
            ).max().item()


def pop_matmul_bound(n, bsz, k, m, *, broadcast: bool):
    """Least time (ms) and what bounds it for one launch: each input read
    once (a broadcast x is one (B,K) block), the output written once, and
    2*N*B*K*M fp32 operations."""
    x_elems = (1 if broadcast else n) * bsz * k
    nbytes = 4 * (x_elems + n * k * m + n * m + n * bsz * m)
    flops = 2 * n * bsz * k * m
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def pop_matmul_backward_bound(n, bsz, k, m, act, grads):
    """Least time (ms) and what bounds it for one backward of a recording
    launch, the gradients in ``grads`` (of "x", "w", "b") asked for: dy
    read, the saved y read unless act is "none", w read for dx, x read
    for dw, each gradient written once; act'(y) * dy per output element
    (1 operation for relu, 3 for tanh), 2*N*B*K*M for each of dx and dw,
    N*B*M for db."""
    act_ops = {"none": 0, "relu": 1, "tanh": 3}[act]
    nbytes = 4 * ((1 + (act != "none")) * n * bsz * m
                  + ("x" in grads) * (n * k * m + n * bsz * k)
                  + ("w" in grads) * (n * bsz * k + n * k * m)
                  + ("b" in grads) * n * m)
    flops = (act_ops * n * bsz * m
             + 2 * n * bsz * k * m * (("x" in grads) + ("w" in grads))
             + ("b" in grads) * n * bsz * m)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------- phases
def phase_kernels():
    """pop_matmul against its plain version, then timed at the path's
    shapes. Returns (max_abs_err, its share of the tolerance, per-layer
    timing rows)."""
    from repro_torch.kernels.pop_matmul import (_launch, _route, pop_matmul,
                                                pop_matmul_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = share = 0.0
    cases = 0
    reset_counts(pop_matmul)
    # the paths' (K, M) and the edges of both routes' tiles: B of 31 and
    # 33 across the 32-row tile, M of 15 and 16 on both sides of the
    # route rule, ragged K and M
    for n in (1, 4, 8):
        for bsz in (1, 4, 31, 33, 256, 1000):
            for k, m in ((3, 256), (256, 256), (256, 1), (255, 1), (256, 15),
                         (256, 16), (33, 17)):
                w = torch.randn((n, k, m), generator=gen,
                                device="cuda") / k ** 0.5
                b = torch.randn((n, m), generator=gen, device="cuda")
                xs = torch.randn((n, bsz, k), generator=gen, device="cuda")
                one = torch.randn((bsz, k), generator=gen, device="cuda")
                for x in (xs, one.unsqueeze(0).expand(n, bsz, k)):
                    for act in ("none", "relu", "tanh"):
                        y = pop_matmul(x, w, b, activation=act)
                        ref = pop_matmul_plain(x, w, b, activation=act)
                        torch.cuda.synchronize()
                        torch.testing.assert_close(y, ref, **TOL)
                        worst = max(worst, (y - ref).abs().max().item())
                        share = max(share, tol_share(y, ref, TOL))
                        cases += 1
    by_route = dict(pop_matmul.launches_by_route)
    if min(by_route.values()) == 0 or sum(by_route.values()) != cases:
        raise AssertionError(f"pop_matmul cases by route {by_route}, "
                             f"{cases} cases")
    log(f"pop_matmul == plain on {cases} cases (N 1/4/8, B 1/4/31/33/256/"
        f"1000, (K,M) (3,256) (256,256) (256,1) (255,1) (256,15) (256,16) "
        f"(33,17), x broadcast or not, 3 activations; by route "
        f"{by_route}), max abs err {worst:.3g}")

    # the serving path's three launches: E=4 members, B=256 requests,
    # layer 0 reads the requests broadcast over members (stride 0)
    layers = (("layer_0", 3, 256, "relu", True),
              ("layer_1", 256, 256, "relu", False),
              ("layer_2", 256, 1, "tanh", False))
    acts = {"none": lambda t: t, "relu": torch.relu, "tanh": torch.tanh}
    rows = []
    for name, k, m, act, broadcast in layers:
        n = ENSEMBLE
        w = torch.randn((n, k, m), generator=gen, device="cuda") / k ** 0.5
        b = torch.randn((n, m), generator=gen, device="cuda")
        x = (torch.randn((BATCH, k), generator=gen, device="cuda")
             .unsqueeze(0).expand(n, BATCH, k) if broadcast else
             torch.randn((n, BATCH, k), generator=gen, device="cuda"))
        f = acts[act]

        def kernel():
            return pop_matmul(x, w, b, activation=act)

        def plain():
            return pop_matmul_plain(x, w, b, activation=act)

        def library():
            return f(torch.baddbmm(b[:, None, :], x, w))

        torch.testing.assert_close(library(), plain(), **TOL)
        bound, bound_by = pop_matmul_bound(n, BATCH, k, m,
                                           broadcast=broadcast)
        row = {"layer": name, "n": n, "b": BATCH, "k": k, "m": m,
               "act": act, "x_broadcast": broadcast,
               "route": _route(n, BATCH, k, m),
               **tiled_alternative(_launch, x, w, b, act, plain()),
               "ms": graph_ms(kernel),
               "plain_ms": graph_ms(plain),
               "library_ms": graph_ms(library),
               "eager_ms": eager_ms(kernel),
               "plain_eager_ms": eager_ms(plain),
               "bound_ms": bound, "bound_by": bound_by}
        rows.append(row)
        log(f"pop_matmul {name} (N={n},B={BATCH},K={k},M={m},{act}, "
            f"{row['route']}): "
            f"kernel {row['ms'] * 1e3:.3f} us/launch on the device "
            f"({row['eager_ms'] * 1e3:.3f} us eager with launch overhead), "
            f"plain {row['plain_ms'] * 1e3:.3f} us "
            f"({row['plain_eager_ms'] * 1e3:.3f} us eager), baddbmm "
            f"{row['library_ms'] * 1e3:.3f} us, bound "
            f"{bound * 1e3:.3f} us ({bound_by}){tiled_text(row)}")
    return worst, share, rows


def tiled_alternative(launch, x, w, b, act, want):
    """For a layer on the narrow route, the tiled route's time on the
    same inputs (its answer checked against the plain one, ``want``,
    first): what the narrow route saves, measured beside it. Empty for a
    layer on the tiled route."""
    from repro_torch.kernels.pop_matmul import _route

    if _route(*x.shape, w.shape[2]) == "tiled":
        return {}
    y = launch(x, w, b, act, route="tiled")
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want, **TOL)
    return {"tiled_route_ms": graph_ms(
        lambda: launch(x, w, b, act, route="tiled"))}


def tiled_text(row):
    return ("" if "tiled_route_ms" not in row else
            f"; on the tiled route instead "
            f"{row['tiled_route_ms'] * 1e3:.3f} us")


def _shape_rows(layers, count, net, dx_heads=1):
    """(net, K, M, act, forwards per update step, backwards per update
    step as ((gradients asked, count), ...)) for each layer. Of TD3's 24
    forwards of a step the 9 target ones run under no_grad; the actor loss
    differentiates the actor, and the critic's Q1 head for dx alone (the
    critic's weights do not require grad there; its Q2 head records and
    is never differentiated); the critic loss both heads. A first layer's
    input (obs, or obs and action) needs no dx: 12 backwards a step. A
    critic's ``dx_heads`` is how many of its heads the actor loss
    differentiates (TD3 1, SAC 2: its min(Q1, Q2)); any other net is
    differentiated once a step."""
    rows = []
    for i, (k, m, act) in enumerate(layers):
        full = "wb" if i == 0 else "xwb"
        back = ((full, 2), ("x", dx_heads)) if net == "critic" else \
            ((full, 1),)
        rows.append((net, k, m, act, count, back))
    return rows


TRAIN_SHAPES = (_shape_rows(ACTOR_LAYERS, 2, "actor")       # actor, target
                + _shape_rows(CRITIC_LAYERS, 6, "critic"))  # 3 x twin heads
SAC_DQN["sac"]["shapes"] = (_shape_rows(SAC_ACTOR_LAYERS, 2, "actor")
                            + _shape_rows(CRITIC_LAYERS, 6, "critic",
                                          dx_heads=2))
SAC_DQN["dqn"]["shapes"] = _shape_rows(DQN_LAYERS, 2, "q")


def served_batch_routes():
    """pop_matmul launches of each route in one served batch: the actor's
    3 layers over E members and B requests (also one acting or evaluation
    step of training, whose shapes take the same routes), by the wrapper's
    rule, which must give SERVED_BATCH_ROUTES."""
    return expect_routes(
        pop_matmul_routes(ENSEMBLE, BATCH,
                          [(k, m, 1) for k, m, _ in ACTOR_LAYERS]),
        SERVED_BATCH_ROUTES, "a served batch")


def update_step_routes():
    """pop_matmul launches of each route in one population update step:
    the 24 forwards of TRAIN_SHAPES, by the wrapper's rule, which must
    give UPDATE_STEP_ROUTES."""
    return expect_routes(
        pop_matmul_routes(POPULATION, TRAIN["batch"],
                          [(k, m, c) for _, k, m, _, c, _ in TRAIN_SHAPES]),
        UPDATE_STEP_ROUTES, "an update step")


def expect_routes(derived, want, what):
    if derived != want:
        raise AssertionError(f"pop_matmul's route rule gives {derived} for "
                             f"{what}, want {want}")
    return derived


def phase_pop_matmul_training():
    """pop_matmul under autograd at the training path's shapes: dx, dw, db
    through the kernel route (``PopMatmul``) against the plain route,
    relu and tanh; then the forward and the backward's batched matmuls
    timed per shape. Returns (max grad err, forward max err, the worst
    share of its tolerance of either, rows)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst_grad, worst_fwd, share, cases = grad_cases(
        [(k, m) for _, k, m, _, _, _ in TRAIN_SHAPES], gen)
    log(f"pop_matmul backward (dx, dw, db) kernel route == plain route on "
        f"{cases} cases, max abs err {worst_grad:.3g}")
    return worst_grad, worst_fwd, share, training_rows(TRAIN_SHAPES, gen)


def grad_cases(kms, gen):
    """dx, dw, db through the kernel route (``PopMatmul``) against the
    plain route at N=8, B=256 for each (K, M), relu and tanh. Returns (max
    grad err, forward max err, the worst share of its tolerance, cases)."""
    from repro_torch.kernels.pop_matmul import pop_matmul, pop_matmul_plain

    n, bsz = POPULATION, TRAIN["batch"]
    worst_grad = worst_fwd = share = 0.0
    cases = 0
    for k, m in kms:
        for act in ("relu", "tanh"):
            x = torch.randn((n, bsz, k), generator=gen, device="cuda")
            w = torch.randn((n, k, m), generator=gen,
                            device="cuda") / k ** 0.5
            b = torch.randn((n, m), generator=gen, device="cuda")
            dy = torch.randn((n, bsz, m), generator=gen, device="cuda")
            ins = [t.clone().requires_grad_(True) for t in (x, w, b)]
            y = pop_matmul(*ins, activation=act)
            got = torch.autograd.grad(y, ins, dy)
            ins_p = [t.clone().requires_grad_(True) for t in (x, w, b)]
            yp = pop_matmul_plain(*ins_p, activation=act)
            want = torch.autograd.grad(yp, ins_p, dy)
            torch.cuda.synchronize()
            torch.testing.assert_close(y, yp, **TOL)
            worst_fwd = max(worst_fwd, (y - yp).abs().max().item())
            share = max(share, tol_share(y, yp, TOL))
            for name, g, r in zip(("dx", "dw", "db"), got, want):
                torch.testing.assert_close(g, r, **GRAD_TOL,
                                           msg=f"{name} K={k} M={m} {act}")
                worst_grad = max(worst_grad, (g - r).abs().max().item())
                share = max(share, tol_share(g, r, GRAD_TOL))
            cases += 1
    return worst_grad, worst_fwd, share, cases


def training_rows(shapes, gen, label="", bsz=None):
    """The forward and the backward's batched matmuls of each row of a
    shape table (N=8, B=256 or ``bsz``), timed beside their bounds, the
    plain version and ``baddbmm``+act."""
    from repro_torch.kernels.pop_matmul import (_launch, _route, pop_matmul,
                                                pop_matmul_plain)

    n, bsz = POPULATION, bsz or TRAIN["batch"]
    acts = {"none": lambda t: t, "relu": torch.relu, "tanh": torch.tanh}
    rows = []
    for net, k, m, act, count, back in shapes:
        w = torch.randn((n, k, m), generator=gen, device="cuda") / k ** 0.5
        b = torch.randn((n, m), generator=gen, device="cuda")
        x = torch.randn((n, bsz, k), generator=gen, device="cuda")
        dy = torch.randn((n, bsz, m), generator=gen, device="cuda")
        y = pop_matmul(x, w, b, activation=act)
        f = acts[act]

        def backward(grads):
            # PopMatmul.backward's arithmetic for the gradients asked
            d = dy * (y > 0) if act == "relu" else (
                dy * (1.0 - y * y) if act == "tanh" else dy)
            return (torch.bmm(d, w.transpose(1, 2)) if "x" in grads else None,
                    torch.bmm(x.transpose(1, 2), d) if "w" in grads else None,
                    d.sum(1) if "b" in grads else None)

        bound, bound_by = pop_matmul_bound(n, bsz, k, m, broadcast=False)
        backs = []
        for grads, c in back:
            back_bound, back_by = pop_matmul_backward_bound(n, bsz, k, m,
                                                            act, grads)
            backs.append({"grads": grads, "per_update_step": c,
                          "ms": graph_ms(lambda: backward(grads)),
                          "bound_ms": back_bound, "bound_by": back_by})
        row = {"net": net, "n": n, "b": bsz, "k": k, "m": m, "act": act,
               "route": _route(n, bsz, k, m),
               **tiled_alternative(_launch, x, w, b, act, pop_matmul_plain(
                   x, w, b, activation=act)),
               "launches_per_update_step": count,
               "ms": graph_ms(lambda: pop_matmul(x, w, b, activation=act)),
               "plain_ms": graph_ms(
                   lambda: pop_matmul_plain(x, w, b, activation=act)),
               "library_ms": graph_ms(
                   lambda: f(torch.baddbmm(b[:, None, :], x, w))),
               "backward": backs,
               "backward_ms_per_step": sum(r["ms"] * r["per_update_step"]
                                           for r in backs),
               "backward_bound_ms_per_step": sum(
                   r["bound_ms"] * r["per_update_step"] for r in backs),
               "bound_ms": bound, "bound_by": bound_by}
        rows.append(row)
        back_txt = ", ".join(
            f"d{'/d'.join(r['grads'])} x{r['per_update_step']} "
            f"{r['ms'] * 1e3:.3f} us (bound {r['bound_ms'] * 1e3:.3f} us, "
            f"{r['bound_by']})" for r in backs)
        log(f"pop_matmul {label}{net} (N={n},B={bsz},K={k},M={m},{act}, "
            f"{row['route']}) x{count} per update step: kernel "
            f"{row['ms'] * 1e3:.3f} us, plain "
            f"{row['plain_ms'] * 1e3:.3f} us, baddbmm "
            f"{row['library_ms'] * 1e3:.3f} us, bound "
            f"{bound * 1e3:.3f} us ({bound_by}){tiled_text(row)}; backward "
            f"bmm {back_txt}")
    return rows


def pop_adam_bound(n, p):
    """Least time (ms) of one pop_adam launch: p, g, mu, nu read and p, mu,
    nu written once (fp32), lr, step, decay and scale read; 17 fp32
    operations per parameter (the scale, the moments, the bias-corrected
    step and the decay)."""
    nbytes = 28 * n * p + 16 * n
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 17 * n * p / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _adam_inputs(gen, n, p):
    """params, grads, mu, nu (N, P), a per-member lr and steps 1, 2 and
    1000 in turn."""
    params, grads, mu = (torch.randn((n, p), generator=gen, device="cuda")
                         for _ in range(3))
    nu = torch.rand((n, p), generator=gen, device="cuda")
    lr = torch.linspace(1e-4, 3e-3, n, device="cuda")
    step = torch.tensor([(1, 2, 1000)[i % 3] for i in range(n)],
                        dtype=torch.int32, device="cuda")
    return params, grads, mu, nu, lr, step


def adam_cases(gen, shapes):
    """pop_adam against its plain version at each (N, P). Returns (max abs
    err, its share of the tolerance)."""
    from repro_torch.kernels.pop_adam import pop_adam, pop_adam_plain

    worst = share = 0.0
    for n, p in shapes:
        args = _adam_inputs(gen, n, p)
        got = pop_adam(*args)
        want = pop_adam_plain(*args)
        torch.cuda.synchronize()
        for name, g, r in zip(("params", "mu", "nu"), got, want):
            torch.testing.assert_close(g, r, **ADAM_TOL,
                                       msg=f"{name} N={n} P={p}")
            worst = max(worst, (g - r).abs().max().item())
            share = max(share, tol_share(g, r, ADAM_TOL))
    return worst, share


def adam_row(gen, net, n, p, per_step=1):
    """One pop_adam launch at (N, P) timed beside its bound, the plain
    version and ``torch._fused_adam_`` over the same flat tensors."""
    from repro_torch.kernels.pop_adam import pop_adam, pop_adam_plain

    args = _adam_inputs(gen, n, p)
    lib = [t.clone() for t in args[:4]]
    lib_step = [torch.tensor(1.0, device="cuda")]

    def library():
        # one fused Adam over the same flat tensors, with ONE lr shared
        # by every member (it takes no per-member lr)
        torch._fused_adam_([lib[0]], [lib[1]], [lib[2]], [lib[3]], [],
                           lib_step, amsgrad=False, lr=3e-4, beta1=0.9,
                           beta2=0.999, weight_decay=0.0, eps=1e-8,
                           maximize=False, grad_scale=None, found_inf=None)

    bound, bound_by = pop_adam_bound(n, p)
    row = {"net": net, "n": n, "p": p, "launches_per_update_step": per_step,
           "ms": graph_ms(lambda: pop_adam(*args)),
           "plain_ms": graph_ms(lambda: pop_adam_plain(*args)),
           "library_ms": graph_ms(library),
           "bound_ms": bound, "bound_by": bound_by,
           "cache": "L2-warm (the same inputs every launch)"}
    log(f"pop_adam {net} (N={n}, P={p}/member): kernel "
        f"{row['ms'] * 1e3:.3f} us, plain {row['plain_ms'] * 1e3:.3f} "
        f"us, _fused_adam_ (shared lr) {row['library_ms'] * 1e3:.3f} "
        f"us, bound {bound * 1e3:.3f} us ({bound_by}), L2-warm")
    return row


def phase_pop_adam():
    """pop_adam against its plain version over ragged sizes with distinct
    per-member lr and step, then timed at the training path's two flat
    sizes (N=8: the actor's and the critic's parameters per member).
    Returns (max_abs_err, its share of the tolerance, rows)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    shapes = [(n, p) for n in (1, 8)
              for p in (1, 4095, 4096, 67073, 134658)]
    worst, share = adam_cases(gen, shapes)
    log(f"pop_adam == plain on {len(shapes)} cases (N in {{1,8}}, ragged "
        f"P, lr per member, step in {{1,2,1000}}), max abs err "
        f"{worst:.3g}, {share:.3g} of the tolerance")
    rows = [adam_row(gen, net, POPULATION, p)
            for net, p in (("actor", 67073), ("critic", 134658))]
    return worst, share, rows


def backwards_of(fn):
    """Runs fn with ``PopMatmul.backward`` counting its calls by (K, M,
    the gradients asked, of "x", "w", "b"); returns fn's result and the
    counts."""
    from repro_torch.kernels import pop_matmul as pm

    seen = collections.Counter()
    orig = vars(pm.PopMatmul)["backward"]

    def backward(ctx, dy):
        _, w, _ = ctx.saved_tensors
        asked = "".join(g for g, need in zip("xwb", ctx.needs_input_grad)
                        if need)
        seen[(w.shape[1], w.shape[2], asked)] += 1
        return orig.__func__(ctx, dy)

    pm.PopMatmul.backward = staticmethod(backward)
    try:
        return fn(), seen
    finally:
        pm.PopMatmul.backward = orig


@contextlib.contextmanager
def kernel_relu_masks(masks, *, replay: bool):
    """The step-1 gradient checks' common ReLU masks. Recording (``replay``
    False): every ``pop_matmul`` call of the kernel route appends its ReLU
    mask (y > 0) to ``masks``, in call order. Replaying: every plain-route
    ReLU (``networks.pop_matmul_plain``) takes the next recorded mask in
    place of its own, so a pre-activation within rounding of zero, where
    the two routes' own masks may differ, gets the kernel route's
    derivative; the replay must consume every mask. Yields a dict whose
    ``"differ"`` counts the mask elements that the plain route's own masks
    would have set otherwise (a device tensor), and ``"elements"``."""
    from repro_torch.kernels import pop_matmul as pm
    from repro_torch.rl import networks as nets

    info = {"differ": 0, "elements": 0}
    if not replay:
        forward = pm._forward

        def recording(x, w, b, activation):
            y = forward(x, w, b, activation)
            if activation == "relu":
                masks.append(y > 0)
            return y

        pm._forward = recording
        try:
            yield info
        finally:
            pm._forward = forward
        return
    plain = nets.pop_matmul_plain

    def replaying(x, w, b=None, *, activation="none"):
        if activation != "relu":
            return plain(x, w, b, activation=activation)
        pre = plain(x, w, b, activation="none")
        mask = masks.pop(0)
        if mask.shape != pre.shape:
            raise AssertionError(f"replayed ReLU mask {tuple(mask.shape)} "
                                 f"for a layer of {tuple(pre.shape)}")
        info["differ"] = info["differ"] + ((pre > 0) != mask).sum()
        info["elements"] += mask.numel()
        return torch.where(mask, pre, 0.0)

    nets.pop_matmul_plain = replaying
    try:
        yield info
    finally:
        nets.pop_matmul_plain = plain
    if masks:
        raise AssertionError(f"{len(masks)} recorded ReLU masks were not "
                             f"replayed: the routes' calls differ")


@contextlib.contextmanager
def moe_routes(routes, *, replay: bool):
    """The card's MoE routing, replayed on the other side of a parity
    check. Recording (``replay`` False): every call of the port's
    ``nn.moe._top_k_gating`` appends the expert indices it chose to
    ``routes``, in call order. Replaying: every call takes the next
    recorded indices in place of its own, its gates its own probabilities
    at those indices (normalised as the gating normalises them), so that a
    token whose k-th and (k+1)-th probabilities lie within rounding of
    each other, or that sits at an expert's capacity edge, takes one route
    on both sides; the replay must consume every record. Yields a dict
    whose ``"differ"`` counts the (token, slot) choices that the replaying
    side's own gating would have made otherwise, and ``"choices"`` all of
    them."""
    from repro_torch.nn import moe

    gating = moe._top_k_gating
    info = {"differ": 0, "choices": 0}
    if not replay:
        def recording(logits, top_k, **kw):
            probs, gates, idx = gating(logits, top_k, **kw)
            routes.append(idx.detach())
            return probs, gates, idx

        moe._top_k_gating = recording
        try:
            yield info
        finally:
            moe._top_k_gating = gating
        return

    def replaying(logits, top_k, *, normalize=True):
        probs, _, own = gating(logits, top_k, normalize=normalize)
        idx = routes.pop(0).to(own.device)
        if idx.shape != own.shape:
            raise AssertionError(f"replayed routes {tuple(idx.shape)} for "
                                 f"a gating of {tuple(own.shape)}")
        info["differ"] += int((idx != own).sum())
        info["choices"] += idx.numel()
        gates = probs.gather(-1, idx)
        if normalize:
            gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
        return probs, gates, idx

    moe._top_k_gating = replaying
    try:
        yield info
    finally:
        moe._top_k_gating = gating
    if routes:
        raise AssertionError(f"{len(routes)} recorded MoE routings were not "
                             f"replayed: the two sides' calls differ")


def lm_param_count(cfg):
    """Parameters of an attention LM of ``cfg`` (GQA or MLA, dense or MoE
    layers), reckoned from the config alone: the embedding (none for an
    ``audio_frames`` config), the head unless tied, the final norm, and
    each layer's norms, attention and MLP (the router, the experts and the
    shared experts of an MoE layer)."""
    d, h = cfg.d_model, cfg.num_heads
    if cfg.mla is not None:
        m = cfg.mla
        attn = (d * h * (m.qk_nope_dim + m.qk_rope_dim)
                + d * m.kv_lora_rank + d * m.qk_rope_dim + m.kv_lora_rank
                + m.kv_lora_rank * h * (m.qk_nope_dim + m.v_dim)
                + h * m.v_dim * d)
    else:
        q, kv = h * cfg.hd, cfg.num_kv_heads * cfg.hd
        attn = 2 * d * q + 2 * d * kv + (q + 2 * kv) * cfg.qkv_bias \
            + 2 * cfg.hd * cfg.qk_norm
    dense = 2 * d + attn + 3 * d * cfg.d_ff
    n_dense, moe_layer = cfg.num_layers, 0
    if cfg.moe is not None:
        e = cfg.moe
        n_dense = e.first_dense_layers
        moe_layer = (2 * d + attn + d * e.num_experts
                     + 3 * e.num_experts * d * e.d_expert
                     + 3 * d * e.d_expert * e.num_shared)
    tables = (cfg.frontend != "audio_frames") + (not cfg.tie_embeddings)
    return (cfg.vocab_size * d * tables + d
            + n_dense * dense + (cfg.num_layers - n_dense) * moe_layer)


def rl_batches(gen, k, n, bsz, obs=3, act=1, discrete=False):
    """``k`` steps of (N, B) replay batches on the card: pendulum's obs 3
    and act 1 by default; ``discrete``: int32 actions in [0, act). Drawn
    in the order of the dict (the order every RL phase drew in before
    this helper served them all)."""
    shape = (k, n, bsz)
    out = {"obs": torch.randn(shape + (obs,), generator=gen, device="cuda")}
    out["action"] = (
        torch.randint(0, act, shape, generator=gen, device="cuda",
                      dtype=torch.int32) if discrete else
        torch.rand(shape + (act,), generator=gen, device="cuda") * 2 - 1)
    out["reward"] = torch.randn(shape, generator=gen, device="cuda")
    out["next_obs"] = torch.randn(shape + (obs,), generator=gen,
                                  device="cuda")
    out["done"] = (torch.rand(shape, generator=gen, device="cuda")
                   < 0.05).float()
    return out


def phase_update_parity():
    """One full-width population update chained 4 times with every kernel
    and again with every plain version, from one state, batch stack and
    noise draw. Step-1 gradients are read off Adam's first moment (after
    one step mu = (1 - b1) g) for the critic of every member and the actor
    of members whose gate opened. Returns (grad err, param err)."""
    from repro_torch.core.hyperparams import sample_hypers
    from repro_torch.core.vectorize import chain_steps
    from repro_torch.envs import make
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.pop_matmul import pop_matmul
    from repro_torch.rl import get_algo, make_agent, td3
    from repro_torch.tree import leaves

    k_steps, n, bsz = 4, POPULATION, TRAIN["batch"]
    agent = make_agent("td3", make("pendulum").spec, device="cuda")
    state = agent.population_init(torch.Generator().manual_seed(SEED), n)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    hypers = sample_hypers(gen, get_algo("td3").hyper_space, n)
    # the actor's gate opens at step 1 for half the members
    hypers["policy_freq"] = torch.tensor([1.0, 0.5] * (n // 2),
                                         device="cuda")
    batches = rl_batches(gen, k_steps, n, bsz)
    noise = torch.randn((k_steps, n, bsz, 1), generator=gen, device="cuda")
    first = {k: v[0] for k, v in batches.items()}
    rest = {k: v[1:] for k, v in batches.items()}

    want_backs = collections.Counter()
    for _, k, m, _, _, back in TRAIN_SHAPES:
        for grads, count in back:
            want_backs[(k, m, grads)] += count
    out, masks = {}, []
    for route, fused_linear, fused in (("kernels", True, None),
                                       ("plain", False, False)):
        update = td3.make_population_update(fused_linear=fused_linear,
                                            fused=fused)
        reset_counts(pop_matmul, pop_adam)
        with kernel_relu_masks(masks, replay=not fused_linear) as masked:
            (s1, _), backs = backwards_of(
                lambda: update(state, first, hypers, noise=noise[0]))
        if fused_linear and backs != want_backs:
            raise AssertionError(f"update: backwards {dict(backs)}, the "
                                 f"timing table says {dict(want_backs)}")
        s4, metrics = chain_steps(update, k_steps - 1)(
            s1, rest, hypers, noise=noise[1:])
        torch.cuda.synchronize()
        counts = (pop_matmul.launches, pop_adam.launches)
        want = (24 * k_steps, 2 * k_steps) if fused is None else (0, 0)
        if counts != want:
            raise AssertionError(f"update ({route}): launches "
                                 f"(pop_matmul, pop_adam) = {counts}, want "
                                 f"{want}")
        by_route = dict(pop_matmul.launches_by_route)
        want_routes = scaled(update_step_routes(),
                             k_steps if fused is None else 0)
        if by_route != want_routes:
            raise AssertionError(f"update ({route}): pop_matmul launches by "
                                 f"route {by_route}, want {want_routes}")
        grads = [m / 0.1 for m in leaves(s1.critic_opt.mu)
                 + leaves(s1.actor_opt.mu)]
        out[route] = (grads, leaves((s4.actor, s4.critic, s4.target_actor,
                                     s4.target_critic)), metrics)
    grad_err = param_err = 0.0
    for g, r in zip(out["kernels"][0], out["plain"][0]):
        torch.testing.assert_close(g, r, **STEP1_GRAD_TOL)
        grad_err = max(grad_err, (g - r).abs().max().item())
    for a, b in zip(out["kernels"][1], out["plain"][1]):
        torch.testing.assert_close(a, b, rtol=0.0, atol=PARAMS_AFTER_4_ATOL)
        param_err = max(param_err, (a - b).abs().max().item())
    for name, v in out["kernels"][2].items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"update: non-finite {name}")
    log(f"update parity, kernels vs plain (N={n}, B={bsz}, full width): "
        f"step-1 gradients max abs err {grad_err:.3g} (rtol 1e-4, atol "
        f"1e-6; {masks_text(masked)}), parameters after {k_steps} steps max"
        f" abs err {param_err:.3g} (atol {PARAMS_AFTER_4_ATOL}); pop_matmul "
        f"launches by route per update step {update_step_routes()}")
    return grad_err, param_err


def masks_text(masked):
    """How many ReLU mask elements the plain route took from the kernel
    route in place of its own, in a step-1 gradient check."""
    return (f"the plain route on the kernel route's ReLU masks, "
            f"{int(masked['differ'])} of {masked['elements']} elements "
            f"differing from its own")


def write_population(ckpt_dir, step, fitness):
    """A seeded TD3 population checkpoint in the layout a population
    trainer's save writes: main tree (population state, strategy state),
    the stacked actors as the "actors" aux tree, size/fitness extras."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.envs import make
    from repro_torch.rl import make_agent

    agent = make_agent("td3", make("pendulum").spec, device="cuda")
    state = agent.population_init(
        torch.Generator().manual_seed(SEED), POPULATION)
    CheckpointManager(ckpt_dir).save(
        step, (state, {}),
        {"size": POPULATION, "fitness": [float(f) for f in fitness]},
        aux={"actors": agent.actor_params(state)})


def check_answers(server, obs, actions, head=None, act_dim=1):
    """Finite actions in [-1, 1] that equal the plain ensemble on the same
    serving set and requests: TD3's actor, or ``head(params, x)``, the
    members' actions on (E, B, obs) requests by plain layers. Returns the
    max abs difference."""
    from repro_torch.rl.networks import pop_actor_apply

    head = head or (lambda params, x: pop_actor_apply(params, x,
                                                      fused=False))
    assert actions.shape == (len(obs), act_dim), actions.shape
    assert np.isfinite(actions).all(), "non-finite actions"
    assert np.abs(actions).max() <= 1.0, "actions outside [-1, 1]"
    params = server.set.params
    x = torch.from_numpy(obs).to("cuda")
    with torch.inference_mode():
        per = head(params, x.unsqueeze(0).expand(server.set.size, *x.shape))
        ref = per[server.set.best] if server.mode == "best" else per.mean(0)
    got = torch.from_numpy(actions).to("cuda")
    torch.testing.assert_close(got, ref, **TOL)
    return (got - ref).abs().max().item()


def phase_serve():
    from repro_torch.kernels.pop_matmul import pop_matmul
    from repro_torch.launch.serve import main as serve_main

    rng = np.random.default_rng(SEED)
    fitness = rng.permutation(POPULATION).astype(np.float64) * 10.0 - 35.0
    results = {}
    worst = 0.0
    with tempfile.TemporaryDirectory() as ckpt_dir:
        write_population(ckpt_dir, 0, fitness)
        for mode, weight in (("mean", "1.0"), ("best", "0.0")):
            argv = ["--algo", "td3", "--env", "pendulum",
                    "--ckpt-dir", ckpt_dir, "--ensemble", str(ENSEMBLE),
                    "--mode", mode, "--fused-linear",
                    "--batch", str(BATCH), "--requests", str(REQUESTS),
                    "--diversity-weight", weight, "--seed", str(SEED)]
            reset_counts(pop_matmul)
            report = serve_main(argv)
            launches = pop_matmul.launches
            by_route = dict(pop_matmul.launches_by_route)
            torch.cuda.synchronize()
            batches = REQUESTS + 2          # warm-up + first batch + timed
            want_routes = scaled(served_batch_routes(), batches)
            if launches != 3 * batches or by_route != want_routes:
                raise AssertionError(
                    f"serve {mode}: pop_matmul launched {launches} times "
                    f"for {batches} served batches (want 3 per batch), by "
                    f"route {by_route} (want {want_routes})")
            server, watcher = report.server, report.watcher
            members = server.set.members.tolist()
            if members[0] != int(np.argmax(fitness)):
                raise AssertionError(f"serve {mode}: the fittest member "
                                     f"is not in slot 0: {members}")
            for obs, actions in report.batches:
                worst = max(worst, check_answers(server, obs, actions))
            results[mode] = {"req_per_s": report.req_per_s,
                             "p50_ms": report.p50_ms,
                             "p99_ms": report.p99_ms,
                             "launches": launches,
                             "launches_by_route": by_route,
                             "members": members}
            log(f"serve {mode}: {report.requests} requests, "
                f"{report.req_per_s:.1f} req/s, p50 {report.p50_ms:.4f} ms "
                f"p99 {report.p99_ms:.4f} ms per batch of {BATCH}, "
                f"{launches} pop_matmul launches {by_route}, members "
                f"{members}")

        # promotion: with diversity weight 0 the rule is the top-k by
        # fitness; a newer checkpoint with another order must move exactly
        # the members that enter and leave the top k
        top = lambda f: set(np.argsort(-f, kind="stable")[:ENSEMBLE].tolist())
        old = top(fitness)
        if set(members) != old:
            raise AssertionError(f"best run served {members}, top-"
                                 f"{ENSEMBLE} by fitness is {sorted(old)}")
        newer_fitness = -fitness
        write_population(ckpt_dir, 10, newer_fitness)
        newer = watcher.poll(server)
        new = top(newer_fitness)
        event = watcher.events[-1]
        if (newer is None or newer.step != 10 or server.set is not newer
                or set(newer.members.tolist()) != new
                or event["promoted"] != sorted(new - old)
                or event["demoted"] != sorted(old - new)):
            raise AssertionError(f"promotion event {event} does not match "
                                 f"the rule: promote {sorted(new - old)}, "
                                 f"demote {sorted(old - new)}")
        obs = np.asarray(rng.standard_normal((BATCH, 3)), np.float32)
        reset_counts(pop_matmul)
        worst = max(worst, check_answers(server, obs, server.serve(obs)))
        if pop_matmul.launches_by_route != served_batch_routes():
            raise AssertionError("promoted set did not serve through "
                                 "pop_matmul")
        log(f"promotion at step 10: +{event['promoted']} "
            f"-{event['demoted']}; serving {newer.members.tolist()}")
    log(f"served answers == plain ensemble, max abs err {worst:.3g}")
    return results, worst


def _sync_ms(fn, reps: int = 3) -> float:
    """Host wall time of one ``fn()`` call that ends synchronised, the mean
    of ``reps`` calls after one warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_busy_share(fn):
    """(busy share, device ms, wall ms) of one synchronised ``fn()`` call:
    the summed duration of the device's work (torch.profiler's CUPTI
    trace, _kernel_events) over the wall time. The share is None when the
    trace shows no device activity or lost some of the window's
    kernels."""
    wall, events, (kept, n) = _kernel_events(fn)
    busy_us = sum(end - start for _, start, end, _ in events)
    share = busy_us / (wall * 1e3) if busy_us > 0 and kept == n else None
    return share, busy_us / 1e3, wall


def phase_train(ckpt_dir):
    """The training entry point with the launch counts set to 0 just
    before and read just after; then the path's times."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.replay_buffer import buffer_sample
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.pop_matmul import pop_matmul
    from repro_torch.launch.train import main as train_main

    t = TRAIN
    argv = ["--algo", "td3", "--env", "pendulum",
            "--population", str(POPULATION), "--steps", str(t["steps"]),
            "--pbt-interval", str(t["pbt_interval"]),
            "--eval-every", str(t["eval_every"]),
            "--num-envs", str(t["num_envs"]),
            "--collect-steps", str(t["collect_steps"]),
            "--updates-per-iter", str(t["updates_per_iter"]),
            "--batch", str(t["batch"]), "--fused-adam", "--fused-linear",
            "--ckpt-dir", ckpt_dir, "--seed", str(SEED)]
    reset_counts(pop_matmul, pop_adam)
    t0 = time.perf_counter()
    report = train_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"pop_matmul": pop_matmul.launches,
                "pop_adam": pop_adam.launches}
    by_route = dict(pop_matmul.launches_by_route)

    iters, k = t["steps"], t["updates_per_iter"]
    per_iter = t["collect_steps"] * t["num_envs"]
    updating = sum((i + 1) * per_iter >= t["batch"] for i in range(iters))
    evals = iters // t["eval_every"]
    want = {"pop_adam": 2 * k * updating,
            "pop_matmul": (24 * k * updating + 3 * t["collect_steps"] * iters
                           + 3 * EVAL_STEPS * evals)}
    want_routes = added(
        scaled(update_step_routes(), k * updating),
        scaled(served_batch_routes(),
               t["collect_steps"] * iters + EVAL_STEPS * evals))
    if launches != want or by_route != want_routes:
        raise AssertionError(f"train: launches {launches}, want {want} (24 "
                             f"pop_matmul + 2 pop_adam per update step, 3 "
                             f"pop_matmul per acting and evaluation step); "
                             f"pop_matmul by route {by_route}, want "
                             f"{want_routes}")
    trainer = report.trainer
    if report.metrics is None or not all(
            torch.isfinite(v).all() for v in report.metrics.values()):
        raise AssertionError(f"train: losses not finite: {report.metrics}")
    if not np.isfinite(report.best_fitness):
        raise AssertionError(f"train: fitness {report.best_fitness}")
    replace = max(1, round(POPULATION * 0.3))
    moved = [sum(p != i for i, p in enumerate(lin))
             for _, lin in report.evolutions]
    if replace not in moved:
        raise AssertionError(f"train: no evolve replaced {replace} members: "
                             f"{report.evolutions}")
    latest = CheckpointManager(ckpt_dir).latest()
    if latest != iters - 1:
        raise AssertionError(f"train: latest checkpoint {latest}, want "
                             f"{iters - 1}")
    saved_fitness = CheckpointManager(ckpt_dir).peek_extra()["fitness"]
    if saved_fitness is None or len(saved_fitness) != POPULATION or \
            not np.isfinite(saved_fitness).all():
        raise AssertionError(f"train: the checkpoint's fitness is "
                             f"{saved_fitness}, want {POPULATION} finite "
                             f"values")
    log(f"train: {iters} iterations in {wall:.2f}s through the entry point "
        f"({wall * 1e3 / iters:.1f} ms per iteration, evaluations "
        f"included); launches {launches}, pop_matmul by route {by_route}; "
        f"{len(report.evolutions)} evolves "
        f"{report.evolutions}; best fitness {report.best_fitness:+.2f}; "
        f"checkpoint step {latest}")

    # the path's times, after the counted run
    engine = trainer.rollout
    iter_ms = _sync_ms(trainer.env_iteration)
    batches = buffer_sample(engine.bufs, trainer.generator, t["batch"], k,
                            filled=engine.filled())

    def update():
        trainer.state, _ = trainer.update(trainer.state, batches,
                                          trainer.hypers, trainer.generator)

    update_ms = _sync_ms(update)
    member_step_ms = update_ms / (k * POPULATION)
    share, busy_ms, busy_wall_ms = device_busy_share(trainer.env_iteration)
    eval_ms = _sync_ms(trainer.evaluate_fitness, reps=1)
    log(f"train: {iter_ms:.2f} ms per iteration (collect {t['collect_steps']}"
        f" x {t['num_envs']} envs + {k} updates), {update_ms:.2f} ms per "
        f"{k}-step update call, {member_step_ms * 1e3:.2f} us per "
        f"member-update-step, {eval_ms:.2f} ms per evaluation "
        f"({EVAL_STEPS} steps x {EVAL_ENVS} envs)")
    # the profiler slows the host; the device's work is the same, so the
    # busy time is also given as a share of the unprofiled iteration
    share_unprofiled = None if share is None else busy_ms / iter_ms
    log(f"train: device busy {busy_ms:.2f} ms of a {busy_wall_ms:.2f} ms "
        f"profiled iteration: busy share "
        f"{'not measured' if share is None else f'{share:.4f}'} "
        f"({'not measured' if share is None else f'{share_unprofiled:.4f}'}"
        f" of the {iter_ms:.2f} ms unprofiled iteration)")
    return {"launches": launches, "pop_matmul_launches_by_route": by_route,
            "seconds": wall,
            "iter_ms": iter_ms, "update_call_ms": update_ms,
            "member_update_step_ms": member_step_ms, "eval_ms": eval_ms,
            "device_busy_share": share, "device_busy_ms": busy_ms,
            "busy_wall_ms": busy_wall_ms,
            "device_busy_share_unprofiled": share_unprofiled,
            "best_fitness": report.best_fitness,
            "saved_fitness": saved_fitness,
            "evolutions": report.evolutions}


def phase_train_serve(ckpt_dir, fitness):
    """Serve the checkpoint the train phase wrote, whose extras carry
    ``fitness``: the fittest member in slot 0, answers vs the plain
    ensemble. Returns the max abs err."""
    from repro_torch.kernels.pop_matmul import pop_matmul
    from repro_torch.launch.serve import main as serve_main

    requests = 16
    argv = ["--algo", "td3", "--env", "pendulum", "--ckpt-dir", ckpt_dir,
            "--ensemble", str(ENSEMBLE), "--mode", "mean", "--fused-linear",
            "--batch", str(BATCH), "--requests", str(requests),
            "--seed", str(SEED)]
    reset_counts(pop_matmul)
    report = serve_main(argv)
    torch.cuda.synchronize()
    want_routes = scaled(served_batch_routes(), requests + 2)
    if pop_matmul.launches_by_route != want_routes:
        raise AssertionError(f"train -> serve: pop_matmul launches by route "
                             f"{pop_matmul.launches_by_route} for "
                             f"{requests + 2} batches (want "
                             f"{want_routes})")
    members = report.server.set.members.tolist()
    if members[0] != int(np.argmax(fitness)):
        raise AssertionError(f"train -> serve: the fittest member "
                             f"{int(np.argmax(fitness))} is not in slot 0: "
                             f"{members}")
    worst = 0.0
    for obs, actions in report.batches:
        worst = max(worst, check_answers(report.server, obs, actions))
    log(f"train -> serve: the trained checkpoint served "
        f"{report.requests} requests, {report.req_per_s:.1f} req/s, "
        f"members {members} (the fittest in slot 0), answers == plain "
        f"ensemble, max abs err {worst:.3g}")
    return worst


# ------------------------------------------------------------ LM serving
def wkv6_bound(b, h, s, d):
    """Least time (ms) and what bounds it for one wkv6 launch: r, k, v, lw
    read and y written once, u, the initial and the final state, at the
    memory's rate; and the products that every form of the scan does, per
    token and head the state's readout (r S) and update (k v^T, the
    decay), 2 D^2 operations each. They run on the tensor cores, where
    float32 accuracy takes three TF32 passes."""
    nbytes = 4 * (5 * b * h * s * d + h * d + 2 * b * h * d * d)
    ops = 3 * 4 * b * h * s * d * d
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_TF32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def ssd_bound(b, h, s, p, n):
    """Least time (ms) and what bounds it for one ssd launch: x read and y
    written once, dt, a, b, c, the initial and the final state, at the
    memory's rate; and the products that every form of the scan does, per
    token and head the state's rank-1 update (dt x b^T) and the readout
    (S c), 2 P N operations each. They run on the tensor cores, where
    float32 accuracy takes three TF32 passes."""
    nbytes = 4 * (2 * b * h * s * p + b * h * s + h + 2 * b * s * n
                  + 2 * b * h * p * n)
    ops = 3 * 4 * b * h * s * p * n
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_TF32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _wkv6_inputs(gen, b, h, s, d, *, model_layout: bool, mild=False):
    """r, k, v, lw, u, state with lw = -exp(U(-3, 3)) (decays down to
    exp(-e^3) per step, as strong as the model's; with ``mild``
    -exp(U(-6, -3)), under which the state carried over a tile does not
    fade) and a nonzero state; with ``model_layout`` r/k/v/lw are
    (B,S,H,D) tensors transposed, as the model hands them over."""
    shape = (b, s, h, d) if model_layout else (b, h, s, d)
    r, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for _ in range(3))
    lo, span = (-6.0, 3.0) if mild else (-3.0, 6.0)
    lw = -torch.exp(torch.rand(shape, generator=gen, device="cuda") * span
                    + lo)
    if model_layout:
        r, k, v, lw = (t.transpose(1, 2) for t in (r, k, v, lw))
    u = 0.3 * torch.randn((h, d), generator=gen, device="cuda")
    state = torch.randn((b, h, d, d), generator=gen, device="cuda")
    return r, k, v, lw, u, state


def _ssd_inputs(gen, b, h, s, p, n, *, model_layout: bool):
    """x, dt, a, b, c, state with a = -linspace(1, 16, H) (the model's
    -exp(a_log)), dt = softplus(N(0,1) + 1) and a nonzero state; with
    ``model_layout`` x, b, c are slices of one (B,S,H*P+2N) tensor and dt
    a (B,S,H) tensor transposed, as the model hands them over."""
    if model_layout:
        xbc = torch.randn((b, s, h * p + 2 * n), generator=gen,
                          device="cuda")
        x = xbc[..., :h * p].reshape(b, s, h, p).transpose(1, 2)
        bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
        dt = torch.nn.functional.softplus(torch.randn(
            (b, s, h), generator=gen, device="cuda") + 1).transpose(1, 2)
    else:
        x = torch.randn((b, h, s, p), generator=gen, device="cuda")
        bm, cm = (torch.randn((b, s, n), generator=gen, device="cuda")
                  for _ in range(2))
        dt = torch.nn.functional.softplus(torch.randn(
            (b, h, s), generator=gen, device="cuda") + 1)
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    state = torch.randn((b, h, p, n), generator=gen, device="cuda")
    return x, dt, a, bm, cm, state


def phase_scan_kernel(name):
    """wkv6 or ssd against its plain version on the card: head size 32 and
    64 (N=64 for ssd), chunk 16, 64 and 256 with S = chunk and 8 chunks,
    both layouts, nonzero states, strong decays; S = 200 at chunk 8, which
    the kernels' 32-token tiles leave ragged (for wkv6 also S = 8 and 24,
    one ragged tile, and mild decays at S = 512; for ssd its other state
    sizes N = 16 and 32 at S 16, 128 and 200); then the served path's
    exact shape, checked and timed beside its bound and the plain
    version. Returns (max abs err, its share of the tolerance, row)."""
    if name == "wkv6":
        from repro_torch.kernels.wkv6 import wkv6 as kernel
        from repro_torch.kernels.wkv6 import wkv6_plain as plain
        inputs = lambda gen, b, h, s, d, ml, mild=False: _wkv6_inputs(
            gen, b, h, s, d, model_layout=ml, mild=mild)
        path, chunk_path = (4, 32, 512, 64), 64
        bound, bound_by = wkv6_bound(*path)
    else:
        from repro_torch.kernels.ssd import ssd as kernel
        from repro_torch.kernels.ssd import ssd_plain as plain
        inputs = lambda gen, b, h, s, d, ml, n=64: _ssd_inputs(
            gen, b, h, s, d, n, model_layout=ml)
        path, chunk_path = (4, 112, 512, 64), 256
        bound, bound_by = ssd_bound(*path, 64)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst = share = 0.0
    cases = 0

    def check(args, chunk):
        nonlocal worst, share, cases
        got = kernel(*args, chunk=chunk)
        want = plain(*args, chunk=chunk)
        torch.cuda.synchronize()
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, **SCAN_TOL)
            worst = max(worst, (g - r).abs().max().item())
            share = max(share, tol_share(g, r, SCAN_TOL))
        cases += 1

    for d in (32, 64):
        for chunk in (16, 64, 256):
            for s in (chunk, 8 * chunk):
                for model_layout in (False, True):
                    check(inputs(gen, 2, 3, s, d, model_layout), chunk)
        if name == "wkv6":
            for model_layout in (False, True):
                for s in (8, 24, 200):
                    check(inputs(gen, 2, 3, s, d, model_layout), 8)
                check(inputs(gen, 2, 3, 512, d, model_layout, True), 64)
        if name == "ssd":
            for model_layout in (False, True):
                check(inputs(gen, 2, 3, 200, d, model_layout), 8)
                for n in (16, 32):
                    for s, chunk in ((16, 16), (128, 16), (200, 8)):
                        check(inputs(gen, 2, 3, s, d, model_layout, n),
                              chunk)
    args = inputs(gen, *path, True)
    check(args, chunk_path)
    ragged = (", S 200 at chunk 8; N 16/32 at S 16, 128 and 200"
              if name == "ssd" else
              ", S 8/24/200 at chunk 8; mild decays at S 512")
    log(f"{name} == plain on {cases} cases (head size 32/64, chunk "
        f"16/64/256, S = chunk and 8 chunks{ragged}, both layouts, the "
        f"path's {path}), max abs err {worst:.3g}, {share:.3g} of the "
        f"tolerance")
    row = {"shape": path, "chunk": chunk_path,
           "ms": graph_ms(lambda: kernel(*args, chunk=chunk_path)),
           "plain_ms": graph_ms(lambda: plain(*args, chunk=chunk_path),
                                reps=5, iters=5),
           "bound_ms": bound, "bound_by": bound_by}
    log(f"{name} {path} chunk {chunk_path}: kernel {row['ms'] * 1e3:.3f} us "
        f"per launch, plain {row['plain_ms'] * 1e3:.3f} us, bound "
        f"{bound * 1e3:.3f} us ({bound_by}); no PyTorch call computes it")
    return worst, share, row


def flash_bound(b, h, hkv, s, d, element_bytes=2):
    """Least time (ms) and what bounds it for one causal flash_attention
    launch: q, k, v read and o written once; the causal half of the two
    products, 4 B H S^2/2 D operations, at the bf16 tensor-core rate."""
    nbytes = element_bytes * (2 * b * h * s * d + 2 * b * hkv * s * d)
    ops = 4 * b * h * s * s // 2 * d
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _flash_inputs(gen, b, h, hkv, s, d, dtype, *, model_layout: bool):
    """q, k, v in (B,H,S,D) / (B,Hkv,S,D); with ``model_layout`` they are
    (B,S,H,D) tensors transposed, as the model hands them over."""
    def one(heads):
        shape = (b, s, heads, d) if model_layout else (b, heads, s, d)
        t = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        return t.transpose(1, 2) if model_layout else t
    return one(h), one(hkv), one(hkv)


def phase_flash_kernel():
    """flash_attention against its plain version on the card over head
    sizes, GQA groups, lengths, masks, layouts and types; then timed at
    the served shapes beside its bound, its plain version and PyTorch's
    scaled_dot_product_attention. Returns (max abs err, its share of the
    tolerance, {config: row})."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    worst = share = 0.0
    cases = 0
    reset_counts(flash_attention)
    for dtype in (torch.float32, torch.bfloat16):
        tol = FLASH_TOL[dtype]
        for d in (32, 64, 112, 128, 256):
            for group in (1, 2, 4, 7):
                # 63, 65 and 129 straddle the bf16 route's 64-row and
                # 64-key tiles (32-key at D=256), 200 leaves a ragged tile
                for s in (1, 63, 64, 65, 128, 129, 200, 512):
                    for causal in (True, False):
                        for model_layout in (False, True):
                            q, k, v = _flash_inputs(
                                gen, 1, 2 * group, 2, s, d, dtype,
                                model_layout=model_layout)
                            got = flash_attention(q, k, v, causal=causal)
                            want = flash_attention_plain(q, k, v,
                                                         causal=causal)
                            torch.cuda.synchronize()
                            torch.testing.assert_close(
                                got.float(), want.float(), **tol,
                                msg=f"D={d} group={group} S={s} "
                                    f"causal={causal} {dtype}")
                            worst = max(worst, (got.float() - want.float())
                                        .abs().max().item())
                            share = max(share, tol_share(
                                got.float(), want.float(), tol))
                            cases += 1
    by_route = dict(flash_attention.launches_by_route)
    if by_route != {"bf16_mma": cases // 2, "f32_fma": cases // 2}:
        raise AssertionError(f"flash_attention cases by route {by_route}, "
                             f"{cases} cases")
    log(f"flash_attention == plain on {cases} cases (D 32/64/112/128/256, "
        f"group 1/2/4/7, S 1/63/64/65/128/129/200/512, causal and not, both "
        f"layouts, float32 at 2e-4 and bf16 at 2e-2; by route {by_route}), "
        f"max abs err {worst:.3g}, {share:.3g} of the tolerance")

    rows = {}
    for arch, (b, h, hkv, s, d) in FLASH_SHAPES.items():
        q, k, v = _flash_inputs(gen, b, h, hkv, s, d, torch.bfloat16,
                                model_layout=True)
        got = flash_attention(q, k, v)
        want = flash_attention_plain(q, k, v)
        lib = sdpa(q, k, v, is_causal=True, enable_gqa=True)
        torch.cuda.synchronize()
        tol = FLASH_TOL[torch.bfloat16]
        torch.testing.assert_close(got.float(), want.float(), **tol)
        torch.testing.assert_close(lib.float(), want.float(), **tol)
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        share = max(share, tol_share(got.float(), want.float(), tol))
        bound, bound_by = flash_bound(b, h, hkv, s, d)
        row = {"shape": (b, h, hkv, s, d), "dtype": "bfloat16",
               "route": "bf16_mma",
               "ms": graph_ms(lambda: flash_attention(q, k, v)),
               "plain_ms": graph_ms(lambda: flash_attention_plain(q, k, v),
                                    reps=5, iters=5),
               "library_ms": graph_ms(lambda: sdpa(q, k, v, is_causal=True,
                                                   enable_gqa=True)),
               "bound_ms": bound, "bound_by": bound_by}
        rows[arch] = row
        log(f"flash_attention {arch} (B,H,Hkv,S,D)={row['shape']} bf16: "
            f"kernel {row['ms'] * 1e3:.3f} us per launch, plain "
            f"{row['plain_ms'] * 1e3:.3f} us, scaled_dot_product_attention "
            f"{row['library_ms'] * 1e3:.3f} us, bound {bound * 1e3:.3f} us "
            f"({bound_by})")
    return worst, share, rows


def _lm_config(arch, **kw):
    from repro_torch.configs import get_config
    return get_config(arch).replace(**kw)


def phase_lm_parity():
    """The served path at full width and reduced depth, in float32:
    rwkv6-1.6b with 2 layers, zamba2-7b with 7 (a 6-layer super-block with
    the shared attention, and a 1-layer tail), qwen2-0.5b, qwen3-8b,
    qwen2-1.5b and gemma-7b with 2 (the last two are served only at this
    depth on the card), and the MoE archs with 2: qwen3-moe-30b-a3b (2
    flash_attention launches) and deepseek-v2-lite-16b (its dense first
    layer and one MoE layer, MLA: no kernel). Weights drawn once on the
    card and copied to the CPU; one 256-token prompt prefilled on both;
    the last logits and every decode-state leaf must agree, the MoE archs'
    with the card's routing replayed on the CPU (``moe_routes``); then the
    stateless forward of qwen2-0.5b and of the MoE archs, every logit, the
    MoE archs' with the card prefill's routing replayed on both sides and
    their last logits held to the prefill's (one group of 256 tokens in
    both). Returns {arch: (max abs err, share of the tolerance)}, and the
    MoE archs' routing counts under "routes"."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.models import lm
    from repro_torch.tree import leaves, tree_map

    counters = {"wkv6": wkv6, "ssd": ssd, "flash_attention": flash_attention}
    out, routing = {}, {}
    for arch, layers, want in LM_PARITY_ARCHS:
        t_arch = time.perf_counter()
        is_moe = arch in MOE
        # the stateless forward's attention launches: the prefill's
        flash_launches = want.get("flash_attention", 0)
        cfg = _lm_config(arch, num_layers=layers, dtype="float32")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
        params = lm.init_params(gen, cfg)
        tokens = torch.randint(0, cfg.vocab_size, (1, PARITY_PROMPT),
                               generator=gen, device="cuda")
        step = lm.make_serve_step(cfg)
        routes = []
        reset_counts(*counters.values())
        with moe_routes(routes, replay=False):
            logits, state = step(params, {"tokens": tokens},
                                 lm.init_decode_state(cfg, 1,
                                                      PARITY_PROMPT + 1,
                                                      device="cuda"), 0)
        torch.cuda.synchronize()
        counts = {k: c.launches for k, c in counters.items()}
        expected = {k: want.get(k, 0) for k in counters}
        # float32: every attention launch on the CUDA-core route
        flash_routes = dict(flash_attention.launches_by_route)
        if counts != expected or flash_routes["f32_fma"] != counts[
                "flash_attention"]:
            raise AssertionError(f"{arch} parity: launches {counts} "
                                 f"(flash_attention by route "
                                 f"{flash_routes}), want {expected} for "
                                 f"{layers} layers")
        moe_layers = len(routes)
        if is_moe != bool(moe_layers) or (is_moe and moe_layers != layers - (
                cfg.moe.first_dense_layers)):
            raise AssertionError(f"{arch} parity: {moe_layers} MoE "
                                 f"routings for {layers} layers")
        cpu_params = tree_map(lambda t: t.cpu(), params)
        with moe_routes(list(routes), replay=True) as replayed:
            cpu_logits, cpu_state = step(
                cpu_params, {"tokens": tokens.cpu()},
                lm.init_decode_state(cfg, 1, PARITY_PROMPT + 1), 0)
        worst = share = 0.0
        pairs = [(logits[:, -1], cpu_logits[:, -1])] + list(
            zip(leaves(state), leaves(cpu_state)))
        for got, want in pairs:
            got = got.cpu()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{arch} parity: non-finite values")
            torch.testing.assert_close(got, want, **PATH_TOL)
            worst = max(worst, (got - want).abs().max().item())
            share = max(share, tol_share(got, want, PATH_TOL))
        routed = (f"; the card's routing of {moe_layers} MoE layers "
                  f"replayed on the CPU: {replayed['choices']} choices, "
                  f"{replayed['differ']} of which the CPU's own gating "
                  f"makes otherwise" if is_moe else "")
        log(f"{arch} with {layers} layers at full width, fp32, a "
            f"{PARITY_PROMPT}-token prefill: card (kernels) == CPU (plain "
            f"versions) on the last logits and {len(pairs) - 1} state "
            f"leaves, launches {counts}, max abs err {worst:.3g}, "
            f"{share:.3g} of the tolerance{routed}")
        out[arch] = (worst, share)
        if is_moe:
            routing[arch] = {"prefill": dict(replayed)}
        if arch == "qwen2-0.5b" or is_moe:
            prefill_last = logits[:, -1]
            reset_counts(flash_attention)
            with moe_routes(list(routes), replay=True) as card_own:
                logits, none = lm.forward(params, cfg, {"tokens": tokens})
            torch.cuda.synchronize()
            if none is not None or flash_attention.launches != \
                    flash_launches:
                raise AssertionError(f"{arch} stateless forward: "
                                     f"{flash_attention.launches} "
                                     f"flash_attention launches for "
                                     f"{layers} layers")
            with moe_routes(list(routes), replay=True) as cpu_own:
                cpu_logits, _ = lm.forward(cpu_params, cfg,
                                           {"tokens": tokens.cpu()})
            got = logits.cpu()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{arch} stateless: non-finite values")
            torch.testing.assert_close(got, cpu_logits, **PATH_TOL)
            err = (got - cpu_logits).abs().max().item()
            err_share = tol_share(got, cpu_logits, PATH_TOL)
            extra = ""
            if is_moe:
                # the stateless form groups the 256 tokens as the prefill
                # does: its last logits are the prefill's
                torch.testing.assert_close(logits[:, -1], prefill_last,
                                           **PATH_TOL)
                routing[arch].update(stateless_card=dict(card_own),
                                     stateless_cpu=dict(cpu_own))
                extra = (f"; the prefill's routing replayed on both, "
                         f"{card_own['differ']} (card) and "
                         f"{cpu_own['differ']} (CPU) of "
                         f"{card_own['choices']} choices their own gating "
                         f"makes otherwise; the last logits == the "
                         f"prefill's")
            log(f"{arch} stateless forward, {layers} layers at full width, "
                f"fp32, {PARITY_PROMPT} tokens: card == CPU on every logit, "
                f"{flash_attention.launches} flash_attention launches, max "
                f"abs err {err:.3g}, {err_share:.3g} of the tolerance"
                + extra)
            out[arch] = (max(worst, err), max(share, err_share))
        if is_moe:
            routing[arch]["seconds"] = round(time.perf_counter() - t_arch, 1)
            log(f"{arch} parity took {routing[arch]['seconds']} s")
        del params, cpu_params, state, logits, cpu_state, cpu_logits
    torch.cuda.empty_cache()
    out["routes"] = routing
    out["backward"] = lm_backward_check()
    return out


def lm_backward_check():
    """A backward through ``lm.forward`` on the card: zamba2-7b, rwkv6-1.6b
    and qwen2-0.5b at .smoke() width (ssm_chunk 16, 32 tokens, so the
    scans take their chunked form) with every parameter requiring grad.
    No kernel may launch (``kernels.ops`` sends a differentiated forward
    to ``nn``); every parameter's gradient of mean(logits * w) must equal
    the CPU's; and each kernel wrapper, handed a CUDA tensor that
    requires grad, must raise. Returns {arch: (max abs err, share of the
    tolerance)}."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.models import lm
    from repro_torch.tree import leaves, tree_map

    counters = {"wkv6": wkv6, "ssd": ssd, "flash_attention": flash_attention}
    out = {}
    for arch in ("zamba2-7b", "rwkv6-1.6b", "qwen2-0.5b"):
        cfg = get_config(arch).smoke().replace(ssm_chunk=16)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        params = lm.init_params(gen, cfg)
        tokens = torch.randint(0, cfg.vocab_size, (2, BACKWARD_SEQ),
                               generator=gen, device="cuda")
        w = torch.randn((2, BACKWARD_SEQ, cfg.vocab_size), generator=gen,
                        device="cuda") / (2 * BACKWARD_SEQ * cfg.vocab_size)
        cpu_params = tree_map(lambda t: t.cpu(), params)

        def grads(tree, toks, wts):
            flat = leaves(tree)
            for t in flat:
                t.requires_grad_(True)
            logits, _ = lm.forward(tree, cfg, {"tokens": toks})
            (logits * wts).sum().backward()
            return [t.grad if t.grad is not None else torch.zeros_like(t)
                    for t in flat]

        reset_counts(*counters.values())
        got = grads(params, tokens, w)
        torch.cuda.synchronize()
        counts = {k: c.launches for k, c in counters.items()}
        if any(counts.values()):
            raise AssertionError(f"{arch} backward: kernels launched under "
                                 f"autograd: {counts}")
        want = grads(cpu_params, tokens.cpu(), w.cpu())
        worst = share = 0.0
        for g_card, g_cpu in zip(got, want):
            g_card = g_card.cpu()
            if not torch.isfinite(g_card).all():
                raise AssertionError(f"{arch} backward: non-finite gradient")
            tol = dict(rtol=BACKWARD_RTOL, atol=BACKWARD_ATOL_OF_MAX
                       * g_cpu.abs().max().item())
            torch.testing.assert_close(g_card, g_cpu, **tol)
            worst = max(worst, (g_card - g_cpu).abs().max().item())
            if tol["atol"] > 0:
                share = max(share, tol_share(g_card, g_cpu, tol))
        log(f"{arch} backward at .smoke() width, {BACKWARD_SEQ} tokens: no "
            f"kernel launched, card == CPU on all {len(got)} parameter "
            f"gradients, max abs err {worst:.3g}, {share:.3g} of the "
            f"tolerance")
        out[arch] = (worst, share)
        del params, cpu_params, got, want

    # each wrapper refuses a CUDA tensor that requires grad
    t = lambda *shape: torch.randn(shape, device="cuda", requires_grad=True)
    calls = {
        "flash_attention": lambda: flash_attention(
            t(1, 2, 16, 32), t(1, 2, 16, 32), t(1, 2, 16, 32)),
        "wkv6": lambda: wkv6(t(1, 1, 16, 32), t(1, 1, 16, 32),
                             t(1, 1, 16, 32), -t(1, 1, 16, 32).exp(),
                             t(1, 32), t(1, 1, 32, 32), chunk=16),
        "ssd": lambda: ssd(t(1, 1, 16, 32), t(1, 1, 16).exp(), -t(1).exp(),
                           t(1, 16, 16), t(1, 16, 16), t(1, 1, 32, 16),
                           chunk=16)}
    reset_counts(*counters.values())
    for name, call in calls.items():
        try:
            call()
        except ValueError as err:
            if "no backward" not in str(err):
                raise
        else:
            raise AssertionError(f"{name} took a CUDA tensor that requires "
                                 f"grad")
    if any(c.launches for c in counters.values()):
        raise AssertionError("a wrapper launched on a tensor requiring grad")
    log("flash_attention, wkv6 and ssd each refuse a CUDA tensor that "
        "requires grad (ValueError: no backward)")
    torch.cuda.empty_cache()
    return out


def _profile_step(step):
    """(device busy ms, wall ms, top kernels by device time) of one
    synchronised ``step()`` under torch.profiler (_kernel_events; busy
    None when the window lost kernels)."""
    wall, events, (kept, n) = _kernel_events(step)
    by_name = collections.Counter()
    for _, start, end, name in events:
        by_name[name] += end - start
    top = by_name.most_common(6)
    busy = sum(by_name.values()) / 1e3 if kept == n else None
    return busy, wall, [(name[:60], us / 1e3) for name, us in top]


def phase_lm_serve():
    """Each config at its full published size through the port's entry
    point, ``--batch 4 --prompt-len 512 --tokens 8``: the launch counts
    set to 0 just before each run and read just after (one flash_attention
    launch per GQA attention layer or shared-block call of the prefill: 24
    for qwen2-0.5b, 36 for qwen3-8b, 14 for zamba2-7b, 48 for
    qwen3-moe-30b-a3b; 24 wkv6 launches for rwkv6-1.6b, 81 ssd for
    zamba2-7b, none for deepseek-v2-lite-16b, whose MLA and MoE layers
    compute in plain PyTorch; nothing else), the tokens' shape and range,
    the peak of allocated memory under 70 GB (qwen3-moe's weights alone
    are 61 GB, so only one copy of them may be alive at a time: the
    reports hold the tokens and numbers only); a second run for warm
    times; then one prefill and one decode step profiled. Returns {arch:
    numbers}."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.pop_matmul import pop_matmul
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import lm

    counters = {"flash_attention": flash_attention, "wkv6": wkv6, "ssd": ssd,
                "pop_matmul": pop_matmul, "pop_adam": pop_adam}
    out = {}
    b, s, t = LM_SERVE["batch"], LM_SERVE["prompt_len"], LM_SERVE["tokens"]
    for arch, want in LM_SERVE_ARCHS:
        t_arch = time.perf_counter()
        cfg = _lm_config(arch)
        argv = ["--arch", arch, "--batch", str(b), "--prompt-len", str(s),
                "--tokens", str(t), "--seed", str(SEED)]
        torch.cuda.reset_peak_memory_stats()
        # what earlier phases still hold; the run's own peak is above it
        before = torch.cuda.memory_allocated()
        reset_counts(*counters.values())
        report = serve_main(argv)
        torch.cuda.synchronize()
        counts = {k: c.launches for k, c in counters.items()}
        expected = {k: want.get(k, 0) for k in counters}
        # the served prefill's attention is bf16: all on the tensor cores
        flash_routes = dict(flash_attention.launches_by_route)
        want_routes = {"bf16_mma": expected["flash_attention"], "f32_fma": 0}
        if counts != expected or flash_routes != want_routes:
            raise AssertionError(f"serve {arch}: launches {counts}, "
                                 f"flash_attention by route {flash_routes}; "
                                 f"want {expected}, {want_routes}")
        tokens = report.tokens
        if tuple(tokens.shape) != (b, 1 + t) or not (
                0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size):
            raise AssertionError(f"serve {arch}: tokens {tuple(tokens.shape)}"
                                 f" in [{int(tokens.min())}, "
                                 f"{int(tokens.max())}]")
        peak = torch.cuda.max_memory_allocated() - before
        warm = serve_main(argv)
        state_bytes = sum(
            int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
            for shape, dt in _shape_leaves(
                lm.decode_state_shapes(cfg, b, s + t + 1)))
        log(f"serve {arch} (batch {b}, prompt {s}, {t} tokens): launches "
            f"{counts}, flash_attention by route {flash_routes}; "
            f"{report.num_params} parameters, "
            f"{report.weight_bytes} weight bytes, {state_bytes} decode-state "
            f"bytes, peak {peak} bytes allocated above the {before} held "
            f"before the run")
        log(f"serve {arch}: prefill {report.prefill_ms:.2f} ms cold, "
            f"{warm.prefill_ms:.2f} ms warm; {report.decode_ms_per_token:.3f}"
            f" / {warm.decode_ms_per_token:.3f} ms per decode step (cold / "
            f"warm)")

        # one prefill and one decode step of the same model, profiled
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = lm.init_params(gen, cfg, dtype=lm.compute_dtype(cfg))
        prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                device="cuda")
        step = lm.make_serve_step(cfg)
        state = lm.init_decode_state(cfg, b, s + t + 1, device="cuda")
        # as the CLI feeds them: zero audio frames, no image patches
        prompt = lm.frontend_inputs(cfg, prompts, patches=False)
        token = lm.frontend_inputs(cfg, prompts[:, :1], patches=False)
        step(params, prompt, state, 0)                     # warm
        prof = {}
        for phase, fn in (
                ("prefill", lambda: step(params, prompt, state, 0)),
                ("decode", lambda: step(params, token, state, s))):
            busy, wall, top = _profile_step(fn)
            prof[phase] = {"busy_ms": busy, "wall_ms": wall, "top": top}
            log(f"serve {arch} {phase}: device busy "
                + ("not measured" if busy is None else
                   f"{busy:.3f} ms of {wall:.3f} ms profiled "
                   f"({busy / wall:.4f})") + "; top kernels "
                + ", ".join(f"{n} {ms:.3f} ms" for n, ms in
                            top[:6 if arch in MOE else 4]))
        # the cold and warm runs' and the profile's peak: one copy of the
        # weights alive at a time
        peak_allocated = torch.cuda.max_memory_allocated()
        if peak_allocated >= LM_PEAK_LIMIT:
            raise AssertionError(f"serve {arch}: peak allocated "
                                 f"{peak_allocated:,} bytes, limit "
                                 f"{LM_PEAK_LIMIT:,.0f}")
        log(f"serve {arch}: peak allocated {peak_allocated:,} bytes over "
            f"both runs and the profile (limit {LM_PEAK_LIMIT:,.0f})")
        out[arch] = {"launches": counts,
                     "flash_attention_by_route": flash_routes,
                     "num_params": report.num_params,
                     "weight_bytes": report.weight_bytes,
                     "state_bytes": state_bytes, "peak_bytes": peak,
                     "max_memory_allocated_bytes": peak_allocated,
                     "allocated_before_bytes": before,
                     "prefill_ms_cold": report.prefill_ms,
                     "prefill_ms": warm.prefill_ms,
                     "decode_ms_per_token_cold": report.decode_ms_per_token,
                     "decode_ms_per_token": warm.decode_ms_per_token,
                     "profile": prof,
                     "seconds": round(time.perf_counter() - t_arch, 1)}
        if arch in MOE + FRONTENDS:
            log(f"serve {arch} took {out[arch]['seconds']} s")
        del report, warm, params, state, prompts, prompt, token
        torch.cuda.empty_cache()
    return out


# ------------------------------------------- LM training and Fig. 2
def _lm_hypers(n, device):
    """Per-member LM hypers of the update parity phase: two learning-rate
    scales and decays, the warmup as the CLI's (one step of lr 0)."""
    return {"lr_scale": torch.tensor([1.0, 0.5] * (n // 2), device=device),
            "weight_decay": torch.tensor([0.1, 0.03] * (n // 2),
                                         device=device),
            "warmup_frac": torch.full((n,), 0.25, device=device)}


def _leaf_paths(tree, prefix=""):
    """The '/'-joined key path of each leaf, in flatten order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}/{k}")]
    return [prefix]


def _lm_state_on(state, device):
    """A fresh LM population (its Adam moments zero) on ``device``, in flat
    buffers of its own: the parameters copied, the moments made as zeros
    there (no copy across), after holding ``state``'s moments zero where
    they are."""
    from repro_torch.pop import LMState
    from repro_torch.tree import flat_views, leaves, tree_map

    def flat(tree, copy=True):
        """``tree``'s leaves copied straight into a new ``(N, P)`` buffer
        on ``device`` (one copy, no staging tree), or zeros: its views."""
        xs = leaves(tree)
        shape = (xs[0].shape[0], sum(x[0].numel() for x in xs))
        if not copy:
            if any(x.any() for x in xs):
                raise AssertionError("a fresh LM population's Adam moments "
                                     "are not zero")
            return flat_views(torch.zeros(shape, device=device), tree)
        buffer = torch.empty(shape, dtype=torch.float32, device=device)
        views = flat_views(buffer, tree)
        tree_map(lambda d, x: d.copy_(x), views, tree)
        return views
    return LMState(params=flat(state.params),
                   opt_state=state.opt_state._replace(
                       step=state.opt_state.step.to(device),
                       mu=flat(state.opt_state.mu, copy=False),
                       nu=flat(state.opt_state.nu, copy=False)),
                   step=state.step.to(device))


def phase_pop_adam_lm():
    """pop_adam at the LM population's flat size, qwen2-0.5b's 494,032,768
    parameters a member for 4 members (120,614 blocks on the grid's first
    axis, past the 65,535 its second allows), and at 2^28 + 1, just past
    the old grid's limit, with a per-member decay and clip scale: the
    kernel against its plain version, which runs on the card over column
    chunks (it is elementwise; whole, its temporaries would not fit beside
    the inputs and outputs); the in-place form against the out-of-place
    one, bit for bit; then timed beside its bound, the plain version (the
    chunks' sum) and ``torch._fused_adamw_``. Every launch reads and
    writes 55.3 GB at the LM's size, far past the 50 MB L2: cold by
    construction. Returns (max abs err, share of tolerance, rows)."""
    from repro_torch.kernels.pop_adam import pop_adam, pop_adam_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    worst = share = 0.0
    rows = []
    chunk = 1 << 25
    for n, p in POP_ADAM_LM:
        params, grads, mu = (torch.randn((n, p), generator=gen,
                                         device="cuda") for _ in range(3))
        nu = torch.rand((n, p), generator=gen, device="cuda")
        lr = torch.linspace(1e-4, 3e-3, n, device="cuda")
        step = torch.tensor([(1, 2, 1000)[i % 3] for i in range(n)],
                            dtype=torch.int32, device="cuda")
        extra = dict(wd=torch.linspace(0.0, 0.3, n, device="cuda"),
                     scale=torch.linspace(1.0, 0.25, n, device="cuda"))
        args = (params, grads, mu, nu, lr, step)
        reset_counts(pop_adam)
        got = pop_adam(*args, **extra)
        if pop_adam.launches != 1:
            raise AssertionError(f"pop_adam (N={n}, P={p}): "
                                 f"{pop_adam.launches} launches, want 1")

        def plain_chunks(check):
            for c in range(0, p, chunk):
                cols = slice(c, min(p, c + chunk))
                want = pop_adam_plain(*(t[:, cols] for t in args[:4]), lr,
                                      step, **extra)
                if check:
                    check(cols, want)

        def check(cols, want):
            # the parameters through the step each took, p - p': p' = p -
            # step cancels where a step is as large as p, and a few ulp of
            # such a step are past atol; the step itself is what is held
            nonlocal worst, share
            p0 = params[:, cols]
            for name, g, r in zip(("step", "mu", "nu"), got, want):
                g = g[:, cols]
                if name == "step":
                    g, r = p0 - g, p0 - r
                torch.testing.assert_close(
                    g, r, **ADAM_TOL,
                    msg=lambda m: f"{name} N={n} P={p} columns {cols}: {m}")
                worst = max(worst, (g - r).abs().max().item())
                share = max(share, tol_share(g, r, ADAM_TOL))

        plain_chunks(check)
        # written in place: the same bits in the inputs
        out = pop_adam(*args, **extra, inplace=True)
        if not (out[0] is params and out[1] is mu and out[2] is nu):
            raise AssertionError("pop_adam(inplace=True) did not return "
                                 "its inputs")
        for name, a, b in zip(("params", "mu", "nu"), out, got):
            if not torch.equal(a, b):
                raise AssertionError(f"pop_adam in place != out of place "
                                     f"({name}, N={n}, P={p})")
        del got, out
        torch.cuda.synchronize()

        # timed on the same buffers, in place (values stay finite)
        rows_of = lambda t: [t[i] for i in range(n)]
        steps_f = [torch.tensor(1.0, device="cuda") for _ in range(n)]

        def library():
            # AdamW over the members' rows, ONE lr and decay for all (it
            # takes no per-member lr, decay or clip)
            torch._fused_adamw_(rows_of(params), rows_of(grads),
                                rows_of(mu), rows_of(nu), [], steps_f,
                                amsgrad=False, lr=3e-4, beta1=0.9,
                                beta2=0.999, weight_decay=0.1, eps=1e-8,
                                maximize=False, grad_scale=None,
                                found_inf=None)

        bound, bound_by = pop_adam_bound(n, p)
        row = {"n": n, "p": p,
               "ms": events_ms(lambda: pop_adam(*args, **extra,
                                                inplace=True)),
               "plain_ms": events_ms(lambda: plain_chunks(None), reps=2),
               "library_ms": events_ms(library),
               "bound_ms": bound, "bound_by": bound_by,
               "cache": "cold (55.3 GB a launch at the LM's size, 30.1 GB "
                        "at the ragged one, past the 50 MB L2)"}
        row["ms_over_bound"] = row["ms"] / bound
        rows.append(row)
        log(f"pop_adam (N={n}, P={p}, decay and clip scale): step and "
            f"moments == plain (rtol 1e-5, atol 1e-6), in place == out of "
            f"place bit for "
            f"bit; kernel {row['ms']:.3f} ms, bound {bound:.3f} ms "
            f"({bound_by}; {row['ms_over_bound']:.2f}x), plain "
            f"{row['plain_ms']:.3f} ms (in column chunks), "
            f"_fused_adamw_ (one lr and decay) {row['library_ms']:.3f} ms")
        del params, grads, mu, nu, args
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    log(f"pop_adam at the LM's sizes: max abs err {worst:.3g}, {share:.3g} "
        f"of the tolerance")
    return worst, share, rows


def phase_lm_update_parity(u):
    """``u["arch"]`` (qwen2-0.5b; deepseek-v2-lite-16b, its dense first
    layer and one MoE layer) at full width with 2 layers, in float32, 2
    members of 2 sequences of 64 tokens: 2 vectorized population updates
    on the card
    (one pop_adam launch each, nothing else launched) against the same
    updates on the CPU (pop_adam's plain version), from one population
    (its parameters copied across, its zero moments made on the host).
    Held: the losses (rtol 1e-4); the gradients Adam took (from its first
    moment: mu = (1 - b1) g after the first step, mu' =
    b1 mu + (1 - b1) g' after the second) at rtol 1e-4, atol 1e-6; the
    parameters after the first step, whose learning rate is 0 under
    warmup, bit for bit; the step p - p' of the second at rtol 1e-4, atol
    1e-6, on every element whose reference gradient is above the
    gradients' atol (1e-6) in both steps. Adam's step is normalised, so
    it turns a gradient's relative error into the same share of lr: a
    gradient the check above lets differ by its own size takes a step
    its rounding decides, and is held only through that gradient. Then
    the same step check against the CPU's step scaled by 1.01, as a run
    with a learning rate 1% off would take it, must fail. An MoE arch's
    card routing is replayed on the CPU (``moe_routes``; the losses carry
    the aux term). The card's and the host's bytes are reckoned from the
    config before the run and logged. Returns the errors and shares."""
    from repro_torch.configs import TrainConfig
    from repro_torch.data.lm_pipeline import host_batches
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.pop import LMAgent, make_update
    from repro_torch.tree import flat_buffer, leaves

    t_phase = time.perf_counter()
    if u["steps"] != 2:
        raise AssertionError("the LM update parity reads the gradients of "
                             "exactly two steps from Adam's moments")
    cfg = _lm_config(u["arch"], num_layers=2, dtype="float32")
    tcfg = TrainConfig(total_steps=u["steps"],
                       warmup_steps=max(u["steps"] // 20, 1))
    n = u["population"]
    p_member = lm_param_count(cfg)
    # card: parameters, mu, nu, the gradients' buffer, mu after step 1,
    # the parameters before step 2, one member's gradient tree; host: the
    # same but the parameters before step 2
    gb = lambda rows: f"{rows * p_member * 4 / 1e9:.1f} GB"
    log(f"LM update {cfg.name}: {p_member:,} parameters a member "
        f"(reckoned from the config), N={n}: about {gb(6 * n + 1)} on the "
        f"card and {gb(5 * n + 1)} on the host")
    card_agent = LMAgent(cfg, tcfg, device="cuda")
    card = card_agent.population_init(torch.Generator().manual_seed(SEED), n)
    if flat_buffer(card.params).shape[1] != p_member:
        raise AssertionError(f"LM update {cfg.name}: "
                             f"{flat_buffer(card.params).shape[1]:,} "
                             f"parameters a member, reckoned {p_member:,}")
    host = _lm_state_on(card, "cpu")
    log(f"LM update {cfg.name}: the population copied to the host")
    card_update = make_update(card_agent, "vectorized")
    host_update = make_update(LMAgent(cfg, tcfg, device="cpu"),
                              "vectorized")
    stream = host_batches(cfg.vocab_size, n * u["batch"], u["seq_len"],
                          seed=SEED)
    counters = (pop_adam, flash_attention, wkv6, ssd)
    reset_counts(*counters)
    paths = _leaf_paths(card.params)

    def worst_of(what, rows, limit=1.0):
        """(max abs err, max share) of (share, err, leaf) rows; raises,
        naming the worst leaves, when a share is above ``limit``."""
        rows = sorted(rows, reverse=True)
        if rows[0][0] > limit:
            raise AssertionError(f"LM update: {what} beyond "
                                 f"{STEP1_GRAD_TOL}; worst leaves (share, "
                                 f"max abs err, leaf): {rows[:5]}")
        return max(r[1] for r in rows), rows[0][0]

    mus, before = [], None
    routing = {"choices": 0, "differ": 0}
    for k in range(u["steps"]):
        tokens = torch.from_numpy(next(stream)).reshape(n, u["batch"],
                                                        u["seq_len"])
        if k == 1:
            # the card's: the host's bit for bit after step 1 (held at the
            # end of step 1), and kept where the step check runs
            before = [p.clone() for p in leaves(card.params)]
        routes = []
        with moe_routes(routes, replay=False):
            card, mc = card_update(card, {"tokens": tokens.cuda()},
                                   _lm_hypers(n, "cuda"))
        with moe_routes(routes, replay=True) as replayed:
            host, mh = host_update(host, {"tokens": tokens},
                                   _lm_hypers(n, "cpu"))
        for key in routing:
            routing[key] += replayed[key]
        torch.testing.assert_close(mc["loss"].cpu(), mh["loss"], rtol=1e-4,
                                   atol=0.0, msg=f"LM update: loss, step "
                                                 f"{k + 1}")
        # mu of the last step stays where it is; that of step 1 is kept
        # beside it (on the card for the card's: the host holds the rest)
        last = k == u["steps"] - 1
        mus.append(tuple(leaves(state.opt_state.mu) if last else
                         [m.clone() for m in leaves(state.opt_state.mu)]
                         for state in (card, host)))
        if k == 0 and not all(torch.equal(a.cpu(), b) for a, b in zip(
                leaves(card.params), leaves(host.params))):
            raise AssertionError("LM update: the parameters moved apart in "
                                 "the first step, whose learning rate is 0")
    torch.cuda.synchronize()
    log(f"LM update {cfg.name}: {u['steps']} steps on the card and the "
        f"host")
    counts = [c.launches for c in counters]
    if counts != [u["steps"], 0, 0, 0]:
        raise AssertionError(f"LM update: launches (pop_adam, flash, wkv6, "
                             f"ssd) = {counts}, want {[u['steps'], 0, 0, 0]}")
    (card1, host1), (card2, host2) = mus
    grad_rows, step_rows, wrong_rows = [], [], []
    held = total = 0
    # on the card (the same IEEE operations; on the host, over deepseek's
    # 2 x 1.03 B elements, they took minutes), a leaf and a member at a
    # time, so that the temporaries stay the size of one member's leaf
    for path, p0, pc, ph, c1, h1, c2, h2 in (
            (path, *(t[i] for t in ts)) for path, *ts in zip(
                paths, before, leaves(card.params), leaves(host.params),
                card1, host1, card2, host2) for i in range(n)):
        ph, h1, h2 = (t.cuda() for t in (ph, h1, h2))
        # the gradients (clipped) each step took, card and CPU
        gc = (c1 / 0.1, (c2 - 0.9 * c1) / 0.1)
        gh = (h1 / 0.1, (h2 - 0.9 * h1) / 0.1)
        for a, b in zip(gc, gh):
            grad_rows.append((tol_share(a, b, STEP1_GRAD_TOL),
                              (a - b).abs().max().item(), path))
        keep = ((gh[0].abs() > LM_STEP_GRAD_FLOOR)
                & (gh[1].abs() > LM_STEP_GRAD_FLOOR))
        held += int(keep.sum())
        total += keep.numel()
        if not keep.any():
            continue
        sc = (p0 - pc)[keep]
        sh = (p0 - ph)[keep]
        step_rows.append((tol_share(sc, sh, STEP1_GRAD_TOL),
                          (sc - sh).abs().max().item(), path))
        wrong_rows.append((tol_share(sc, sh * LM_WRONG_LR, STEP1_GRAD_TOL),
                           0.0, path))
    grad_err, grad_share = worst_of("gradients of steps 1 and 2", grad_rows)
    step_err, step_share = worst_of("the step p - p' of step 2", step_rows)
    wrong_share = max(r[0] for r in wrong_rows)
    if wrong_share <= 1:
        raise AssertionError(f"LM update: the step check passes a learning "
                             f"rate {LM_WRONG_LR}x the CPU's (share "
                             f"{wrong_share:.3g}): it cannot see the "
                             f"optimizer's arithmetic")
    if cfg.moe is not None and not routing["choices"]:
        raise AssertionError(f"LM update {cfg.name}: no MoE routing was "
                             f"replayed")
    routed = (f"; the card's routing replayed on the CPU: "
              f"{routing['choices']} choices, {routing['differ']} of which "
              f"the CPU's own gating makes otherwise"
              if cfg.moe is not None else "")
    seconds = round(time.perf_counter() - t_phase, 1)
    log(f"LM update parity, card (pop_adam kernel) vs CPU (plain), "
        f"{u['arch']} full width 2 layers fp32, N={n}: the gradients of "
        f"steps 1 and 2 max abs err {grad_err:.3g} ({grad_share:.3g} of "
        f"rtol 1e-4, atol 1e-6); parameters after step 1 (lr 0) bit for "
        f"bit; the step p - p' of step 2 max abs err {step_err:.3g} "
        f"({step_share:.3g} of rtol 1e-4, atol 1e-6) on the {held:,} of "
        f"{total:,} elements whose gradients exceed {LM_STEP_GRAD_FLOOR} in "
        f"both steps; against a learning rate {LM_WRONG_LR}x the CPU's "
        f"{wrong_share:.3g} of it; {u['steps']} pop_adam launches, no "
        f"other{routed}; {seconds} s")
    return {"arch": cfg.name, "parameters_per_member": p_member,
            "routing": routing, "seconds": seconds,
            "grad_max_abs_err": grad_err, "grad_share": grad_share,
            "step_max_abs_err": step_err, "step_share": step_share,
            "step_elements_held": held, "elements": total,
            "step_share_at_lr_x1.01": wrong_share}


def phase_lm_train():
    """qwen2-0.5b at full published width and depth (24 layers, remat on,
    bf16 compute over float32 masters), a population of 4, 4 sequences of
    512 tokens a member and step, 4 steps with PBT every 2, through
    ``PopTrainer(LMAgent(...))`` as the CLI builds it (no checkpoint: one
    would write about 24 GB). The launch counts set to 0 just before the
    run and read just after: one pop_adam launch a step, no other kernel.
    Losses finite and falling from step 1 to step 4 for at least 3 of the
    4 members; an evolve at steps 2 and 4. Then one step of each backend
    timed (tokens/s per member), the vectorized one profiled, and the
    peak of allocated memory held under 70 GB. Returns the numbers."""
    from repro_torch.configs import (HyperSpace, PopulationConfig,
                                     TrainConfig)
    from repro_torch.data.lm_pipeline import host_batches
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.pop_matmul import pop_matmul
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.pop import LMAgent, PopTrainer, make_update
    from repro_torch.tree import flat_buffer

    t = LM_TRAIN
    cfg = _lm_config(t["arch"])
    if not (cfg.remat and cfg.dtype == "bfloat16"):
        raise AssertionError(f"{cfg.name}: want remat and bf16, got "
                             f"{cfg.remat}, {cfg.dtype}")
    tcfg = TrainConfig(total_steps=t["steps"],
                       warmup_steps=max(t["steps"] // 20, 1), seed=SEED)
    n, steps = t["population"], t["steps"]
    pcfg = PopulationConfig(size=n, pbt_interval=t["pbt_interval"],
                            hyper_space=HyperSpace(**LM_HYPER_SPACE))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    trainer = PopTrainer(LMAgent(cfg, tcfg, device="cuda"), pcfg, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    p = flat_buffer(trainer.state.params).shape[1]
    if p != LM_PARAMS:
        raise AssertionError(f"{cfg.name}: {p} parameters a member, want "
                             f"{LM_PARAMS}")
    stream = host_batches(cfg.vocab_size, n * t["batch"], t["seq_len"],
                          seed=SEED)
    batches = [torch.from_numpy(next(stream)).reshape(
        n, t["batch"], t["seq_len"]) for _ in range(steps + 1)]
    losses, lineages = [], []

    def on_step(step, metrics, lineage):
        losses.append(metrics["loss"].tolist())
        lineages.append(None if lineage is None else lineage.tolist())

    counters = {"pop_adam": pop_adam, "flash_attention": flash_attention,
                "wkv6": wkv6, "ssd": ssd, "pop_matmul": pop_matmul}
    reset_counts(*counters.values())
    t0 = time.perf_counter()
    trainer.run(steps, lambda step: {"tokens": batches[step].cuda()},
                on_step=on_step)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    want = dict.fromkeys(counters, 0) | {"pop_adam": steps}
    if launches != want:
        raise AssertionError(f"LM train: launches {launches}, want {want}")
    if not all(np.isfinite(row).all() for row in losses):
        raise AssertionError(f"LM train: non-finite losses {losses}")
    falling = sum(losses[-1][i] < losses[0][i] for i in range(n))
    if falling < n - 1:
        raise AssertionError(f"LM train: losses fell from step 1 to step "
                             f"{steps} for {falling} of {n} members: "
                             f"{losses}")
    evolved = [i + 1 for i, lin in enumerate(lineages) if lin is not None]
    want_evolved = list(range(t["pbt_interval"], steps + 1,
                              t["pbt_interval"]))
    if evolved != want_evolved:
        raise AssertionError(f"LM train: evolved at steps {evolved}, want "
                             f"{want_evolved}")
    log(f"LM train {cfg.name} ({p:,} parameters a member, N={n}, "
        f"{t['batch']}x{t['seq_len']} tokens a member and step): losses by "
        f"step {[[round(x, 4) for x in row] for row in losses]}, falling "
        f"for {falling} of {n}; lineage at steps {evolved}: "
        f"{[lin for lin in lineages if lin is not None]}; launches "
        f"{launches}; population built in {init_s:.2f} s, {steps} steps "
        f"in {run_s:.2f} s")

    # one step of each backend on the trained population, timed
    batch = {"tokens": batches[steps].cuda()}
    tokens = t["batch"] * t["seq_len"]
    sequential = make_update(trainer.agent, "sequential")

    def vec_step():
        trainer.state, _ = trainer.update(trainer.state, batch,
                                          trainer.hypers, trainer.generator)

    def seq_step():
        trainer.state, _ = sequential(trainer.state, batch, trainer.hypers,
                                      trainer.generator)

    reset_counts(pop_adam)
    vec_ms = _sync_ms(vec_step, reps=2)
    if pop_adam.launches != 3:
        raise AssertionError(f"LM train: {pop_adam.launches} pop_adam "
                             f"launches in 3 vectorized steps")
    reset_counts(pop_adam)
    seq_ms = _sync_ms(seq_step, reps=2)
    if pop_adam.launches != 0:
        raise AssertionError(f"LM train: the sequential arm launched "
                             f"pop_adam {pop_adam.launches} times")
    share, busy_ms, busy_wall_ms = device_busy_share(vec_step)
    peak = torch.cuda.max_memory_allocated()
    if peak >= LM_PEAK_LIMIT:
        raise AssertionError(f"LM train: peak allocated {peak:,} bytes, "
                             f"limit {LM_PEAK_LIMIT:,.0f}")
    out = {"arch": cfg.name, "parameters_per_member": p, "population": n,
           "tokens_per_member_step": tokens, "steps": steps,
           "losses": losses, "falling": falling,
           "lineages": lineages, "launches": launches,
           "population_init_s": init_s, "run_s": run_s,
           "vectorized_step_ms": vec_ms, "sequential_step_ms": seq_ms,
           "tokens_per_s_per_member": {
               "vectorized": tokens / (vec_ms / 1e3),
               "sequential": tokens / (seq_ms / 1e3)},
           "device_busy_share": share, "device_busy_ms": busy_ms,
           "busy_wall_ms": busy_wall_ms,
           "allocated_before_bytes": before,
           "max_memory_allocated_bytes": peak}
    log(f"LM train: a step takes {vec_ms:.1f} ms vectorized (one pop_adam "
        f"launch), {seq_ms:.1f} ms sequential (stock AdamW, no kernel): "
        f"{out['tokens_per_s_per_member']['vectorized']:.0f} and "
        f"{out['tokens_per_s_per_member']['sequential']:.0f} tokens/s per "
        f"member; device busy {busy_ms:.1f} ms of a {busy_wall_ms:.1f} ms "
        f"profiled vectorized step (share "
        f"{'not measured' if share is None else f'{share:.4f}'}); peak "
        f"allocated {peak:,} bytes (before the phase {before:,})")
    del trainer, sequential
    torch.cuda.empty_cache()
    return out


def phase_lm_cli(arch="qwen2-0.5b"):
    """``python -m repro_torch.launch.train --arch ARCH --smoke
    --population 2 --steps 4 --pbt-interval 2 --batch 2 --seq-len 64
    --ckpt-dir <fresh>`` on the card with each backend, through
    ``main``: 4 pop_adam launches (vectorized) or none (sequential), an
    evolve at steps 2 and 4, the checkpoint at step 3, whose parameters
    read back bit for bit. Returns {backend: final loss}."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.launch.train import main as train_main
    from repro_torch.tree import leaves

    out = {}
    argv = [arch if a == LM_CLI[1] else a for a in LM_CLI]
    for backend in ("vectorized", "sequential"):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            ckpt = str(Path(d) / "ck")
            reset_counts(pop_adam)
            report = train_main(argv + ["--ckpt-dir", ckpt, "--backend",
                                        backend])
            torch.cuda.synchronize()
            want = 4 if backend == "vectorized" else 0
            if pop_adam.launches != want:
                raise AssertionError(f"LM CLI {arch} ({backend}): "
                                     f"{pop_adam.launches} pop_adam "
                                     f"launches, want {want}")
            if [s for s, _ in report.evolutions] != [2, 4]:
                raise AssertionError(f"LM CLI {arch} ({backend}): "
                                     f"evolutions {report.evolutions}")
            mgr = CheckpointManager(ckpt)
            params = report.trainer.state.params
            saved = mgr.restore_aux("actors", params)
            if mgr.latest() != 3 or not all(
                    np.array_equal(a, b.cpu().numpy())
                    for a, b in zip(leaves(saved), leaves(params))):
                raise AssertionError(f"LM CLI {arch} ({backend}): the "
                                     f"checkpoint does not read back bit "
                                     f"for bit")
            if not np.isfinite(report.final_loss):
                raise AssertionError(f"LM CLI {arch} ({backend}): final "
                                     f"loss {report.final_loss}")
            out[backend] = report.final_loss
        log(f"LM CLI {arch} ({backend}): final loss "
            f"{report.final_loss:.4f}, evolutions {report.evolutions}, "
            f"{pop_adam.launches} pop_adam launches, checkpoint step 3 read "
            f"back bit for bit; {time.perf_counter() - t0:.1f} s")
    return out


def phase_fig2():
    """The paper's Fig. 2 unit on the card: TD3 at the repo's width
    (``HIDDEN=(256,256)``), batches of 256, 8 chained update steps a
    call, for N in 1, 8 and 32: ms per member-update-step of the
    sequential arm (each member's step on plain dense layers and the stock
    Adam, in a Python loop; no kernel) and the vectorized one (every
    member at once, 24 pop_matmul and 2 pop_adam launches a step), each
    one call timed with CUDA events after a warm-up call of one step.
    Returns the
    numbers, with each arm's ratio of a call's time at N=32 to N=1."""
    from repro_torch.core.hyperparams import sample_hypers
    from repro_torch.envs import make
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.pop_matmul import pop_matmul
    from repro_torch.pop import make_update
    from repro_torch.rl import get_algo, make_agent
    from repro_torch.tree import tree_map

    k, bsz = FIG2["num_steps"], FIG2["batch"]
    agent = make_agent("td3", make("pendulum").spec, device="cuda")
    rows = {"sequential": {}, "vectorized": {}}
    for n in FIG2["sizes"]:
        state = agent.population_init(torch.Generator().manual_seed(SEED), n)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
        hypers = sample_hypers(gen, get_algo("td3").hyper_space, n)
        batches = rl_batches(gen, k, n, bsz)
        for backend in rows:
            update = make_update(agent, backend, num_steps=k)
            st = tree_map(torch.clone, state)
            # warm-up: one step through the same code (kernels built,
            # memory cached), then the timed call of k steps
            make_update(agent, backend)(
                st, {key: v[0] for key, v in batches.items()}, hypers, gen)
            torch.cuda.synchronize()
            reset_counts(pop_matmul, pop_adam)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            st, metrics = update(st, batches, hypers, gen)
            end.record()
            end.synchronize()
            call_ms = start.elapsed_time(end)
            launches = (pop_matmul.launches, pop_adam.launches)
            want = (24 * k, 2 * k) if backend == "vectorized" else (0, 0)
            if launches != want:
                raise AssertionError(f"fig2 ({backend}, N={n}): launches "
                                     f"(pop_matmul, pop_adam) {launches}, "
                                     f"want {want}")
            if not all(torch.isfinite(v).all() for v in metrics.values()):
                raise AssertionError(f"fig2 ({backend}, N={n}): non-finite "
                                     f"losses")
            rows[backend][n] = {"call_ms": call_ms,
                                "ms_per_member_update_step":
                                    call_ms / (k * n)}
            log(f"fig2 {backend} N={n}: {call_ms:.2f} ms a call of {k} "
                f"steps, {call_ms / (k * n) * 1e3:.2f} us per "
                f"member-update-step")
            del st
    lo, hi = min(FIG2["sizes"]), max(FIG2["sizes"])
    out = {"batch": bsz, "num_steps": k, "hidden": [256, 256],
           "ms_per_member_update_step": {
               b: {n: r["ms_per_member_update_step"] for n, r in by.items()}
               for b, by in rows.items()},
           "call_ms": {b: {n: r["call_ms"] for n, r in by.items()}
                       for b, by in rows.items()},
           f"call_ratio_n{hi}_over_n{lo}": {
               b: by[hi]["call_ms"] / by[lo]["call_ms"]
               for b, by in rows.items()}}
    log(f"fig2: a call's time at N={hi} over N={lo}: vectorized "
        f"{out[f'call_ratio_n{hi}_over_n{lo}']['vectorized']:.2f}x, "
        f"sequential {out[f'call_ratio_n{hi}_over_n{lo}']['sequential']:.2f}"
        f"x")
    return out


# --------------------------------------- the shared critic, CEM-RL, DvD
def shared_step_routes(n, bsz):
    """pop_matmul launches of each route in one shared-critic update step
    with the DvD term (``core/shared.py``): the policies' 3 layers for the
    target policies' next actions, 3 in the actor loss and 3 for the probe
    embedding, by the wrapper's rule, which must give SHARED_STEP_ROUTES
    (N, B and the probe's size do not move a route)."""
    layers = [(k, m, 3) for k, m, _ in SHARED_ACTOR_LAYERS]
    return expect_routes(pop_matmul_routes(n, bsz, layers),
                         SHARED_STEP_ROUTES, "a shared step")


def phase_shared_update_parity():
    """The shared-critic update (§4.2) at full width: N=8, B=256, obs 17,
    act 6, half the members training, a constant DvD coefficient, chained
    4 times with every kernel and again with every plain version from one
    state, batch stack and noise. Step-1 gradients (Adam's first moments
    / 0.1) and the parameters after 4 steps must agree, members 4-7 must
    be bit-identical to their start, the first step must run the 6
    backwards the code asks for, and every step 9 pop_matmul launches (6
    tiled, 3 narrow) and 1 pop_adam. Returns the numbers."""
    from repro_torch.core import shared
    from repro_torch.core.vectorize import chain_steps
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.pop_matmul import pop_matmul
    from repro_torch.tree import leaves

    k_steps, n, bsz = SHARED["steps"], SHARED["population"], SHARED["batch"]
    state = shared.init(torch.Generator().manual_seed(SEED), SHARED["obs"],
                        SHARED["act"], n, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    batches = rl_batches(gen, k_steps, n, bsz, SHARED["obs"],
                         SHARED["act"])
    noise = torch.randn((k_steps, n, bsz, SHARED["act"]), generator=gen,
                        device="cuda")
    first = {k: v[0] for k, v in batches.items()}
    rest = {k: v[1:] for k, v in batches.items()}
    coef = SHARED["dvd_coef"]
    k_train = max(1, round(n * SHARED["train_frac"]))
    # the backwards of one step: the actor loss's 3 layers and the probe
    # embedding's 3, whose first layer reads obs (no dx)
    want_backs = collections.Counter()
    for i, (k, m, _) in enumerate(SHARED_ACTOR_LAYERS):
        want_backs[(k, m, "wb" if i == 0 else "xwb")] += 2
    out, masks = {}, []
    for route, fused in (("kernels", None), ("plain", False)):
        update = shared.make_shared_critic_update(
            dvd_coef_fn=lambda step: coef, probe_size=SHARED["probe"],
            train_frac=SHARED["train_frac"], fused=fused)
        reset_counts(pop_matmul, pop_adam)
        with kernel_relu_masks(masks, replay=fused is False) as masked:
            (s1, m1), backs = backwards_of(
                lambda: update(state, first, None, noise=noise[0]))
        torch.cuda.synchronize()
        step1 = (pop_matmul.launches, pop_adam.launches)
        if fused is None and (backs != want_backs or step1 != (9, 1)):
            raise AssertionError(f"shared update: step 1 backwards "
                                 f"{dict(backs)} (want {dict(want_backs)}),"
                                 f" launches (pop_matmul, pop_adam) {step1}"
                                 f" (want (9, 1))")
        s4, m4 = chain_steps(update, k_steps - 1)(s1, rest, None,
                                                  noise=noise[1:])
        torch.cuda.synchronize()
        counts = (pop_matmul.launches, pop_adam.launches)
        want = (9 * k_steps, k_steps) if fused is None else (0, 0)
        by_route = dict(pop_matmul.launches_by_route)
        want_routes = scaled(shared_step_routes(n, bsz),
                             k_steps if fused is None else 0)
        if counts != want or by_route != want_routes:
            raise AssertionError(f"shared update ({route}): launches "
                                 f"{counts}, want {want}; by route "
                                 f"{by_route}, want {want_routes}")
        for f in ("policies", "policy_opt", "target_policies"):
            for got, was in zip(leaves(getattr(s4, f)),
                                leaves(getattr(state, f))):
                if not torch.equal(got[k_train:], was[k_train:]):
                    raise AssertionError(f"shared update ({route}): members "
                                         f"{k_train}-{n - 1} moved in {f}")
        for name, v in list(m1.items()) + list(m4.items()):
            if not torch.isfinite(v).all():
                raise AssertionError(f"shared update: non-finite {name}")
        grads = [m / 0.1 for m in leaves(s1.critic_opt.mu)
                 + leaves(s1.policy_opt.mu)]
        out[route] = (grads, leaves((s4.policies, s4.critic,
                                     s4.target_policies, s4.target_critic)))
    grad_err = param_err = share = 0.0
    for g, r in zip(*(out[k][0] for k in ("kernels", "plain"))):
        torch.testing.assert_close(g, r, **STEP1_GRAD_TOL)
        grad_err = max(grad_err, (g - r).abs().max().item())
        share = max(share, tol_share(g, r, STEP1_GRAD_TOL))
    for a, b in zip(*(out[k][1] for k in ("kernels", "plain"))):
        torch.testing.assert_close(a, b, rtol=0.0, atol=PARAMS_AFTER_4_ATOL)
        param_err = max(param_err, (a - b).abs().max().item())
    log(f"shared update parity, kernels vs plain (N={n}, B={bsz}, obs "
        f"{SHARED['obs']}, act {SHARED['act']}, {k_train} trainees, DvD "
        f"coef {coef}, probe {SHARED['probe']}): step-1 gradients max abs "
        f"err {grad_err:.3g} ({share:.3g} of rtol 1e-4, atol 1e-6; "
        f"{masks_text(masked)}), "
        f"parameters after {k_steps} steps {param_err:.3g} (atol "
        f"{PARAMS_AFTER_4_ATOL}); members {k_train}-{n - 1} bit-identical; "
        f"per step 9 pop_matmul launches "
        f"{shared_step_routes(n, bsz)} and 1 pop_adam")
    return {"grad_max_abs_err": grad_err, "grad_share": share,
            "param_max_abs_err": param_err,
            "pop_matmul_per_step": shared_step_routes(n, bsz),
            "pop_adam_per_step": 1}


def phase_shared_kernels():
    """pop_matmul at the DvD probe's shapes (x (20, 17) broadcast over 8
    members, then the hidden and head layers at B=20) and at the update's
    actor layers (N=8, B=256, obs 17, act 6), against the plain version,
    and pop_adam at N=8 with the actor's P: each timed beside its bound,
    the plain version and the library call. Returns (max abs err, share of
    the tolerance, pop_matmul rows, pop_adam row)."""
    from repro_torch.kernels.pop_adam import pop_adam, pop_adam_plain
    from repro_torch.kernels.pop_matmul import (_route, pop_matmul,
                                                pop_matmul_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    n, acts = SHARED["population"], {"none": lambda t: t,
                                     "relu": torch.relu,
                                     "tanh": torch.tanh}
    worst = share = 0.0
    rows = []
    for where, bsz, per_step in (("probe", SHARED["probe"], 1),
                                 ("update", SHARED["batch"], 2)):
        for i, (k, m, act) in enumerate(SHARED_ACTOR_LAYERS):
            broadcast = where == "probe" and i == 0
            w = torch.randn((n, k, m), generator=gen, device="cuda") / k ** .5
            b = torch.randn((n, m), generator=gen, device="cuda")
            x = (torch.randn((bsz, k), generator=gen, device="cuda")
                 .unsqueeze(0).expand(n, bsz, k) if broadcast else
                 torch.randn((n, bsz, k), generator=gen, device="cuda"))
            y = pop_matmul(x, w, b, activation=act)
            ref = pop_matmul_plain(x, w, b, activation=act)
            torch.cuda.synchronize()
            torch.testing.assert_close(y, ref, **TOL)
            worst = max(worst, (y - ref).abs().max().item())
            share = max(share, tol_share(y, ref, TOL))
            f = acts[act]
            bound, bound_by = pop_matmul_bound(n, bsz, k, m,
                                               broadcast=broadcast)
            row = {"where": where, "n": n, "b": bsz, "k": k, "m": m,
                   "act": act, "x_broadcast": broadcast,
                   "route": _route(n, bsz, k, m),
                   "launches_per_update_step": per_step,
                   "ms": graph_ms(lambda: pop_matmul(x, w, b,
                                                     activation=act)),
                   "plain_ms": graph_ms(lambda: pop_matmul_plain(
                       x, w, b, activation=act)),
                   "library_ms": graph_ms(
                       lambda: f(torch.baddbmm(b[:, None, :], x, w))),
                   "bound_ms": bound, "bound_by": bound_by}
            rows.append(row)
            log(f"pop_matmul shared {where} (N={n},B={bsz},K={k},M={m},"
                f"{act}{', x broadcast' if broadcast else ''}, "
                f"{row['route']}): kernel {row['ms'] * 1e3:.3f} us, plain "
                f"{row['plain_ms'] * 1e3:.3f} us, baddbmm "
                f"{row['library_ms'] * 1e3:.3f} us, bound "
                f"{bound * 1e3:.3f} us ({bound_by})")

    p = sum(k * m + m for k, m, _ in SHARED_ACTOR_LAYERS)
    params, grads, mu = (torch.randn((n, p), generator=gen, device="cuda")
                         for _ in range(3))
    nu = torch.rand((n, p), generator=gen, device="cuda")
    lr = torch.linspace(1e-4, 3e-3, n, device="cuda")
    step = torch.arange(1, n + 1, dtype=torch.int32, device="cuda")
    args = (params, grads, mu, nu, lr, step)
    for g, r in zip(pop_adam(*args), pop_adam_plain(*args)):
        torch.testing.assert_close(g, r, **ADAM_TOL)
    lib = [t.clone() for t in args[:4]]
    lib_step = [torch.tensor(1.0, device="cuda")]

    def library():
        torch._fused_adam_([lib[0]], [lib[1]], [lib[2]], [lib[3]], [],
                           lib_step, amsgrad=False, lr=3e-4, beta1=0.9,
                           beta2=0.999, weight_decay=0.0, eps=1e-8,
                           maximize=False, grad_scale=None, found_inf=None)

    bound, bound_by = pop_adam_bound(n, p)
    adam_row = {"net": "shared actor", "n": n, "p": p,
                "launches_per_update_step": 1,
                "ms": graph_ms(lambda: pop_adam(*args)),
                "plain_ms": graph_ms(lambda: pop_adam_plain(*args)),
                "library_ms": graph_ms(library),
                "bound_ms": bound, "bound_by": bound_by}
    log(f"pop_adam shared actor (N={n}, P={p}/member): kernel "
        f"{adam_row['ms'] * 1e3:.3f} us, plain "
        f"{adam_row['plain_ms'] * 1e3:.3f} us, _fused_adam_ (shared lr) "
        f"{adam_row['library_ms'] * 1e3:.3f} us, bound "
        f"{bound * 1e3:.3f} us ({bound_by})")
    return worst, share, rows, adam_row


def _run_counted(fn):
    """``fn()`` with the RL kernels' launch counts set to 0 just before and
    read just after: (result, wall s, pop_matmul, by route, pop_adam)."""
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.pop_matmul import pop_matmul

    reset_counts(pop_matmul, pop_adam)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, pop_matmul.launches,
            dict(pop_matmul.launches_by_route), pop_adam.launches)


def _example_iteration_numbers(name, out):
    """Iteration times and the device's busy share of one more iteration
    (collect, updates, evaluation, evolve) of an example's trainer."""
    trainer = out["trainer"]
    secs = [r["seconds"] for r in out["iters"]]
    share, busy_ms, wall_ms = device_busy_share(
        lambda: trainer.run_env_loop(1, eval_every=1))
    log(f"{name}: ms per iteration {[round(s * 1e3, 1) for s in secs]} "
        f"(the kernels were built before the first); one more iteration "
        f"profiled: device busy {busy_ms:.2f} ms of {wall_ms:.2f}"
        f" ms, share {'not measured' if share is None else f'{share:.4f}'}")
    return {"iter_ms": [s * 1e3 for s in secs],
            "device_busy_share": share, "device_busy_ms": busy_ms,
            "busy_wall_ms": wall_ms}


def phase_cemrl():
    """``repro_torch.examples.cemrl.run`` on pendulum (N=10, train_frac
    0.5, 64 shared-critic updates an iteration) with the launch counts set
    to 0 just before and read just after: the counts the code gives, every
    evolve's lineage all -1, CEM's noise decaying by cem_noise_decay an
    evolve, finite fitness and losses."""
    from repro_torch.examples import cemrl
    from repro_torch.envs import make

    c = CEMRL_RUN
    out, wall, mm, by_route, adam = _run_counted(
        lambda: cemrl.run(population=c["population"], iters=c["iters"],
                          seed=SEED, device="cuda"))
    length = make("pendulum").spec.episode_length
    # the example's settings: 100 acting steps of 2 envs an iteration (a
    # batch of 128 from the first), 64 updates, one 200-step evaluation
    acting = c["iters"] * (100 + length)
    updates = c["iters"] * 64
    want = (3 * acting + 6 * updates, updates)
    want_routes = added(
        scaled(pop_matmul_routes(c["population"], 2,
                                 [(k, m, 1) for k, m, _ in ACTOR_LAYERS]),
               acting),
        scaled(pop_matmul_routes(c["population"], 128,
                                 [(k, m, 2) for k, m, _ in ACTOR_LAYERS]),
               updates))
    if (mm, adam) != want or by_route != want_routes:
        raise AssertionError(f"cemrl: launches (pop_matmul, pop_adam) "
                             f"{(mm, adam)}, want {want}; by route "
                             f"{by_route}, want {want_routes}")
    noise0 = 0.01
    for i, row in enumerate(out["iters"]):
        if row["lineage"] != [-1] * c["population"]:
            raise AssertionError(f"cemrl: evolve {i + 1} lineage "
                                 f"{row['lineage']}")
        want_noise = noise0 * 0.999 ** (i + 1)
        if abs(row["cem_noise"] - want_noise) > 1e-6 * want_noise:
            raise AssertionError(f"cemrl: CEM noise {row['cem_noise']} after"
                                 f" evolve {i + 1}, want {want_noise}")
        if not np.isfinite([row["mean_fitness"], row["critic_loss"],
                            row["actor_loss"], row["sigma"]]).all():
            raise AssertionError(f"cemrl: non-finite numbers in {row}")
    log(f"cemrl: {c['iters']} iterations in {wall:.2f}s; launches "
        f"pop_matmul {mm} {by_route}, pop_adam {adam}; mean fitness by "
        f"iteration {[round(r['mean_fitness'], 2) for r in out['iters']]};"
        f" mean var {[r['sigma'] for r in out['iters']]}; CEM noise "
        f"{[r['cem_noise'] for r in out['iters']]}; lineage all -1")
    return {"population": c["population"], "iters": c["iters"],
            "seconds": wall,
            "launches": {"pop_matmul": mm, "pop_adam": adam},
            "pop_matmul_launches_by_route": by_route,
            "mean_fitness": [r["mean_fitness"] for r in out["iters"]],
            "mean_var": [r["sigma"] for r in out["iters"]],
            "cem_noise": [r["cem_noise"] for r in out["iters"]],
            **_example_iteration_numbers("cemrl", out)}


def phase_dvd():
    """``repro_torch.examples.dvd.run`` on reacher (N=5, 32 updates an
    iteration, dvd_period 400) for 8 iterations, so the update step
    passes 200 and the diversity term is on for the last two, with the
    launch counts set to 0 just before and read just after; the probe's
    logdet at each iteration."""
    from repro_torch.envs import make
    from repro_torch.examples import dvd

    c = DVD_RUN
    out, wall, mm, by_route, adam = _run_counted(
        lambda: dvd.run(population=c["population"], iters=c["iters"],
                        seed=SEED, device="cuda"))
    trainer = out["trainer"]
    steps = int(trainer.state.step)
    if steps != 32 * c["iters"] or             float(trainer.agent.dvd_coef_fn(steps - 1)) == 0.0:
        raise AssertionError(f"dvd: {steps} update steps, the coefficient "
                             f"at the last {trainer.agent.dvd_coef_fn(steps - 1)}"
                             f": the diversity term was never on")
    spec = make("reacher").spec
    layers = ((spec.obs_dim, 256, "relu"), (256, 256, "relu"),
              (256, spec.act_dim, "tanh"))
    # 100 acting steps and a 100-step evaluation an iteration, 32 updates
    # of 9 launches (the DvD embedding included), the probe's embedding
    acting = c["iters"] * (100 + spec.episode_length + 1)
    updates = 32 * c["iters"]
    want = (3 * acting + 9 * updates, updates)
    want_routes = added(
        scaled(pop_matmul_routes(c["population"], 2,
                                 [(k, m, 1) for k, m, _ in layers]), acting),
        scaled(pop_matmul_routes(c["population"], 128,
                                 [(k, m, 3) for k, m, _ in layers]),
               updates))
    if (mm, adam) != want or by_route != want_routes:
        raise AssertionError(f"dvd: launches (pop_matmul, pop_adam) "
                             f"{(mm, adam)}, want {want}; by route "
                             f"{by_route}, want {want_routes}")
    logdet = [r["logdet"] for r in out["iters"]]
    if not np.isfinite(logdet).all() or not all(
            np.isfinite([r["best_fitness"], r["critic_loss"],
                         r["actor_loss"]]).all() for r in out["iters"]):
        raise AssertionError(f"dvd: non-finite numbers in {out['iters']}")
    log(f"dvd: {c['iters']} iterations in {wall:.2f}s, {steps} update "
        f"steps (the diversity term on from step 200); launches pop_matmul "
        f"{mm} {by_route}, pop_adam {adam}; probe logdet by iteration "
        f"{[round(x, 4) for x in logdet]}; best fitness "
        f"{[round(r['best_fitness'], 2) for r in out['iters']]}")
    return {"population": c["population"], "iters": c["iters"],
            "seconds": wall, "update_steps": steps,
            "launches": {"pop_matmul": mm, "pop_adam": adam},
            "pop_matmul_launches_by_route": by_route, "logdet": logdet,
            "best_fitness": [r["best_fitness"] for r in out["iters"]],
            **_example_iteration_numbers("dvd", out)}


def phase_fig4():
    """The paper's Fig. 4 on the card: the shared-critic update at
    ``benchmarks/shared_critic.py``'s grid (obs 17, act 6, B=256, N=2, 4,
    8, 16, every member training, no DvD term), ms per update of the
    vectorized form (6 pop_matmul launches and 1 pop_adam) and of the
    sequential one (no kernel): the median of
    FIG4["reps"] synchronised calls each, taken in turns, with their min
    and max; and the device-busy share of one vectorized call at the
    largest N."""
    from repro_torch.core import shared
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.pop_matmul import pop_matmul

    vec = shared.make_shared_critic_update()
    seq = shared.sequential_shared_critic_update()
    rows = {}
    for n in FIG4["sizes"]:
        state = shared.init(torch.Generator().manual_seed(SEED),
                            SHARED["obs"], SHARED["act"], n, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
        batch = {k: v[0] for k, v in rl_batches(
            gen, 1, n, FIG4["batch"], SHARED["obs"], SHARED["act"]).items()}
        times = {"vectorized": [], "sequential": []}
        for fn in (vec, seq):          # warm-up
            fn(state, batch, None, gen)
        torch.cuda.synchronize()
        reset_counts(pop_matmul, pop_adam)
        for _ in range(FIG4["reps"]):
            for name, fn in (("vectorized", vec), ("sequential", seq)):
                t0 = time.perf_counter()
                _, metrics = fn(state, batch, None, gen)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
                if not all(torch.isfinite(v) for v in metrics.values()):
                    raise AssertionError(f"fig4 ({name}, N={n}): non-finite"
                                         f" losses")
        launches = (pop_matmul.launches, pop_adam.launches)
        if launches != (6 * FIG4["reps"], FIG4["reps"]):
            raise AssertionError(f"fig4 N={n}: launches {launches}, want "
                                 f"{(6 * FIG4['reps'], FIG4['reps'])} "
                                 f"(only the vectorized form launches)")
        row = {name: {"median_ms": float(np.median(t)), "min_ms": min(t),
                      "max_ms": max(t)} for name, t in times.items()}
        row["sequential_over_vectorized"] = (
            row["sequential"]["median_ms"] / row["vectorized"]["median_ms"])
        rows[n] = row
        log(f"fig4 N={n}: vectorized {row['vectorized']['median_ms']:.3f} ms"
            f" an update (min {row['vectorized']['min_ms']:.3f}, max "
            f"{row['vectorized']['max_ms']:.3f}), sequential "
            f"{row['sequential']['median_ms']:.3f} ms (min "
            f"{row['sequential']['min_ms']:.3f}, max "
            f"{row['sequential']['max_ms']:.3f}): "
            f"{row['sequential_over_vectorized']:.2f}x")
        if n == max(FIG4["sizes"]):
            share, busy_ms, wall_ms = device_busy_share(
                lambda: vec(state, batch, None, gen))
            log(f"fig4 N={n}: one vectorized update profiled, device busy "
                f"{busy_ms:.3f} ms of {wall_ms:.3f} ms, share "
                f"{'not measured' if share is None else f'{share:.4f}'}")
            busy = {"n": n, "device_busy_share": share,
                    "device_busy_ms": busy_ms, "busy_wall_ms": wall_ms}
    return {"obs": SHARED["obs"], "act": SHARED["act"],
            "batch": FIG4["batch"], "hidden": [256, 256],
            "reps": FIG4["reps"], "ms_per_update": rows,
            "vectorized_busy": busy}


# ------------------------------------------------------- SAC and DQN
def sac_dqn_step_routes(algo):
    """pop_matmul launches of each route in one SAC or DQN population
    update step, by the wrapper's rule over the algorithm's shape table,
    which must give its ``step_routes``."""
    cfg = SAC_DQN[algo]
    return expect_routes(
        pop_matmul_routes(POPULATION, TRAIN["batch"],
                          [(k, m, c) for _, k, m, _, c, _ in cfg["shapes"]]),
        cfg["step_routes"], f"a {algo} update step")


def _member_params(algo):
    """Parameters a member of each of the algorithm's Adam steps (SAC:
    critic, actor, log_alpha; DQN: the Q-network)."""
    p = lambda layers: sum(k * m + m for k, m, _ in layers)
    if algo == "sac":
        return {"critic": 2 * p(CRITIC_LAYERS), "actor": p(SAC_ACTOR_LAYERS),
                "log_alpha": 1}
    return {"q": p(DQN_LAYERS)}


def phase_sac_dqn_kernels():
    """pop_matmul (both routes, forward and under autograd) against its
    plain version at every (K, M) of SAC_DQN_KM, and pop_adam at SAC's and
    DQN's (N=8, P) and at P=1; then each algorithm's update-step shapes
    timed beside their bounds, the plain versions and the library calls.
    Returns the numbers."""
    from repro_torch.kernels.pop_matmul import (_route, pop_matmul,
                                                pop_matmul_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    worst = share = 0.0
    cases = 0
    want = dict.fromkeys(pop_matmul.launches_by_route, 0)
    reset_counts(pop_matmul)
    for n in (1, POPULATION):
        for bsz in (1, 33, TRAIN["batch"]):
            for k, m in SAC_DQN_KM:
                want[_route(n, bsz, k, m)] += 6
                w = torch.randn((n, k, m), generator=gen,
                                device="cuda") / k ** 0.5
                b = torch.randn((n, m), generator=gen, device="cuda")
                xs = torch.randn((n, bsz, k), generator=gen, device="cuda")
                one = torch.randn((bsz, k), generator=gen, device="cuda")
                for x in (xs, one.unsqueeze(0).expand(n, bsz, k)):
                    for act in ("none", "relu", "tanh"):
                        y = pop_matmul(x, w, b, activation=act)
                        ref = pop_matmul_plain(x, w, b, activation=act)
                        torch.cuda.synchronize()
                        torch.testing.assert_close(y, ref, **TOL)
                        worst = max(worst, (y - ref).abs().max().item())
                        share = max(share, tol_share(y, ref, TOL))
                        cases += 1
    by_route = dict(pop_matmul.launches_by_route)
    if by_route != want or sum(want.values()) != cases:
        raise AssertionError(f"sac/dqn pop_matmul cases by route {by_route}"
                             f", want {want}")
    grad_err, fwd_err, grad_share, grad_n = grad_cases(SAC_DQN_KM, gen)
    log(f"pop_matmul == plain at the SAC/DQN shapes on {cases} forward "
        f"cases ((K,M) {list(SAC_DQN_KM)}, N 1/8, B 1/33/256, x broadcast "
        f"or not, 3 activations; by route {by_route}), max abs err "
        f"{worst:.3g}; backward (dx, dw, db) on {grad_n} cases, max abs err "
        f"{grad_err:.3g}")

    sizes = {(POPULATION, p) for algo in SAC_DQN
             for p in _member_params(algo).values()} | {(1, 1)}
    adam_err, adam_share = adam_cases(gen, sorted(sizes))
    log(f"pop_adam == plain at {sorted(sizes)}, max abs err "
        f"{adam_err:.3g}, {adam_share:.3g} of the tolerance")

    out = {"max_abs_err": max(worst, fwd_err),
           "grad_max_abs_err": grad_err,
           "adam_max_abs_err": adam_err,
           "share": max(share, grad_share),
           "adam_share": adam_share, "forward_cases": cases,
           "backward_cases": grad_n, "by_route": by_route}
    for algo in SAC_DQN:
        rows = training_rows(SAC_DQN[algo]["shapes"], gen,
                             label=f"{algo} ")
        adam = [adam_row(gen, f"{algo} {net}", POPULATION, p)
                for net, p in _member_params(algo).items()]
        per_step = lambda key: sum(r[key] * r["launches_per_update_step"]
                                   for r in rows)
        out[algo] = {
            "work": f"the {sum(r['launches_per_update_step'] for r in rows)}"
                    f" pop_matmul forwards and {len(adam)} pop_adam launches "
                    f"of one {algo} update step (N={POPULATION}, "
                    f"B={TRAIN['batch']}, {SAC_DQN[algo]['env']}); device "
                    f"times, CUDA graph replay, L2-warm",
            "pop_matmul": {key: per_step(key) for key in
                           ("ms", "plain_ms", "bound_ms", "library_ms")},
            "pop_matmul_backward_ms": sum(r["backward_ms_per_step"]
                                          for r in rows),
            "pop_matmul_backward_bound_ms": sum(
                r["backward_bound_ms_per_step"] for r in rows),
            "pop_adam": {key: sum(r[key] for r in adam) for key in
                         ("ms", "plain_ms", "bound_ms", "library_ms")},
            "per_launch": rows, "pop_adam_per_launch": adam}
        log(f"{algo} update step on the card: pop_matmul forwards "
            f"{out[algo]['pop_matmul']['ms'] * 1e3:.3f} us (bound "
            f"{out[algo]['pop_matmul']['bound_ms'] * 1e3:.3f}), backward "
            f"bmm {out[algo]['pop_matmul_backward_ms'] * 1e3:.3f} us, "
            f"pop_adam {out[algo]['pop_adam']['ms'] * 1e3:.3f} us (bound "
            f"{out[algo]['pop_adam']['bound_ms'] * 1e3:.3f})")
    return out


def phase_sac_dqn_update_parity(algo):
    """One full-width SAC or DQN population update (N=8, B=256) chained 4
    times with every kernel and again with every plain version, from one
    state, batch stack, hypers and (SAC) noise: step-1 gradients (Adam's
    first moments / 0.1) and the parameters after 4 steps must agree, the
    first step must run the backwards of the shape table, and every step
    the table's pop_matmul launches by route and the algorithm's pop_adam
    launches. DQN's members start at DQN_START_STEPS: the chain syncs the
    target networks of the first four at their steps 100 and no other."""
    from repro_torch.core.hyperparams import sample_hypers
    from repro_torch.core.vectorize import chain_steps
    from repro_torch.envs import make
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.pop_matmul import pop_matmul
    from repro_torch.rl import get_algo, make_agent
    from repro_torch.tree import leaves

    cfg = SAC_DQN[algo]
    k_steps, n, bsz = 4, POPULATION, TRAIN["batch"]
    agent = make_agent(algo, make(cfg["env"]).spec, device="cuda")
    state = agent.population_init(torch.Generator().manual_seed(SEED), n)
    if algo == "dqn":
        state = state._replace(step=torch.tensor(
            DQN_START_STEPS, dtype=torch.int32, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    hypers = sample_hypers(gen, get_algo(algo).hyper_space, n)
    batches = rl_batches(gen, k_steps, n, bsz, cfg["obs"], cfg["act"],
                         discrete=algo == "dqn")
    noise = (torch.randn((k_steps, n, 2, bsz, cfg["act"]), generator=gen,
                         device="cuda") if algo == "sac" else None)
    first = {k: v[0] for k, v in batches.items()}
    rest = {k: v[1:] for k, v in batches.items()}
    at = lambda i: None if noise is None else noise[i]
    want_backs = collections.Counter()
    for _, k, m, _, _, back in cfg["shapes"]:
        for grads, count in back:
            want_backs[(k, m, grads)] += count
    per_step = sum(r[4] for r in cfg["shapes"])
    out, masks = {}, []
    for route, fused_linear, fused in (("kernels", True, None),
                                       ("plain", False, False)):
        update = agent.module.make_population_update(
            fused_linear=fused_linear, fused=fused)
        reset_counts(pop_matmul, pop_adam)
        with kernel_relu_masks(masks, replay=not fused_linear) as masked:
            (s1, _), backs = backwards_of(
                lambda: update(state, first, hypers, noise=at(0)))
        if fused_linear and backs != want_backs:
            raise AssertionError(f"{algo} update: backwards {dict(backs)}, "
                                 f"the shape table says {dict(want_backs)}")
        s4, metrics = chain_steps(update, k_steps - 1)(
            s1, rest, hypers, noise=None if noise is None else noise[1:])
        torch.cuda.synchronize()
        counts = (pop_matmul.launches, pop_adam.launches)
        want = ((per_step * k_steps, cfg["adam"] * k_steps)
                if fused is None else (0, 0))
        by_route = dict(pop_matmul.launches_by_route)
        want_routes = scaled(sac_dqn_step_routes(algo),
                             k_steps if fused is None else 0)
        if counts != want or by_route != want_routes:
            raise AssertionError(f"{algo} update ({route}): launches "
                                 f"(pop_matmul, pop_adam) {counts}, want "
                                 f"{want}; by route {by_route}, want "
                                 f"{want_routes}")
        for name, v in metrics.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"{algo} update: non-finite {name}")
        if algo == "sac":
            opts = (s1.critic_opt, s1.actor_opt, s1.alpha_opt)
            params = (s4.actor, s4.critic, s4.target_critic, s4.log_alpha)
        else:
            opts = (s1.opt,)
            params = (s4.q, s4.target_q)
            synced = [all(torch.equal(a[i], b[i]) for a, b in
                          zip(leaves(s4.target_q), leaves(state.target_q)))
                      for i in range(n)]
            at_last = [all(torch.equal(a[i], b[i]) for a, b in
                           zip(leaves(s4.target_q), leaves(s4.q)))
                       for i in range(n)]
            want_kept = [all((s + j) % 100 for j in range(1, k_steps + 1))
                         for s in DQN_START_STEPS]
            if synced != want_kept or at_last != [
                    (s + k_steps) % 100 == 0 for s in DQN_START_STEPS]:
                raise AssertionError(f"dqn update ({route}): targets kept "
                                     f"{synced} (want {want_kept}), equal "
                                     f"to q after the chain {at_last}")
        grads = [m / 0.1 for o in opts for m in leaves(o.mu)]
        out[route] = (grads, leaves(params))
    grad_err = param_err = share = 0.0
    for g, r in zip(*(out[k][0] for k in ("kernels", "plain"))):
        torch.testing.assert_close(g, r, **STEP1_GRAD_TOL)
        grad_err = max(grad_err, (g - r).abs().max().item())
        share = max(share, tol_share(g, r, STEP1_GRAD_TOL))
    for a, b in zip(*(out[k][1] for k in ("kernels", "plain"))):
        torch.testing.assert_close(a, b, rtol=0.0, atol=PARAMS_AFTER_4_ATOL)
        param_err = max(param_err, (a - b).abs().max().item())
    log(f"{algo} update parity, kernels vs plain (N={n}, B={bsz}, full "
        f"width, {cfg['env']}): step-1 gradients max abs err "
        f"{grad_err:.3g} ({share:.3g} of rtol 1e-4, atol 1e-6; "
        f"{masks_text(masked)}), parameters "
        f"after {k_steps} steps {param_err:.3g} (atol "
        f"{PARAMS_AFTER_4_ATOL}); per step {per_step} pop_matmul launches "
        f"{sac_dqn_step_routes(algo)} and {cfg['adam']} pop_adam"
        + ("; target networks synced inside the chain for members 0-3 "
           "only" if algo == "dqn" else ""))
    return {"grad_max_abs_err": grad_err, "grad_share": share,
            "param_max_abs_err": param_err,
            "pop_matmul_per_step": sac_dqn_step_routes(algo),
            "pop_adam_per_step": cfg["adam"]}


def _plain_head(algo):
    """The members' served answers by plain layers: SAC's tanh of the
    gaussian's mean, DQN's Q-values."""
    from repro_torch.rl import networks as nets

    if algo == "sac":
        return lambda params, x: torch.tanh(nets.pop_gaussian_actor_apply(
            params, x, fused=False)[0])
    return lambda params, x: nets.pop_q_net_apply(params, x, fused=False)


def check_votes(server, obs, actions, scores=None):
    """A discrete ensemble's ``vote`` answers: valid actions that equal the
    plurality of the members' greedy actions by plain layers (DQN's
    Q-values, or ``scores(params, x)``: PPO's logits), on every request
    where each member's two best scores are further apart than TOL allows
    the kernel to move them. Returns the number of requests left unjudged
    (a near tie, where rounding may pick either action)."""
    assert actions.shape == (len(obs),), actions.shape
    n_act = server.spec.act_dim
    assert set(np.unique(actions).tolist()) <= set(range(n_act)), actions
    x = torch.from_numpy(obs).to("cuda")
    with torch.inference_mode():
        q = (scores or _plain_head("dqn"))(
            server.set.params, x.unsqueeze(0).expand(server.set.size,
                                                     *x.shape))
    top2 = q.topk(2, dim=-1).values
    clear = ((top2[..., 0] - top2[..., 1])
             > 2 * (TOL["atol"] + TOL["rtol"] * top2[..., 0].abs())).all(0)
    votes = torch.nn.functional.one_hot(q.argmax(-1), n_act).sum(0)
    want = votes.argmax(-1).cpu().numpy()
    clear = clear.cpu().numpy()
    if not (actions[clear] == want[clear]).all():
        raise AssertionError("vote answers differ from the plain "
                             "ensemble's plurality")
    return int((~clear).sum())


def phase_sac_dqn_train_serve(algo, ckpt_dir):
    """The training entry point for SAC (pendulum) or DQN (cartpole): 8
    members, PBT, ``--fused-adam --fused-linear``, with the launch counts
    set to 0 just before and read just after; counts, losses, fitness,
    evolutions and the checkpoint are checked, then ms per iteration and
    the busy share measured. Then the checkpoint is served through the
    serving entry point (SAC ``mean``, DQN ``vote``), counted the same
    way (3 pop_matmul launches a batch) and checked against the plain
    ensemble. Returns the numbers."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.envs import make
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.pop_matmul import pop_matmul
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main

    cfg, t = SAC_DQN[algo], SAC_DQN_TRAIN
    spec = make(cfg["env"]).spec
    argv = ["--algo", algo, "--env", cfg["env"],
            "--population", str(POPULATION), "--steps", str(t["steps"]),
            "--pbt-interval", str(t["pbt_interval"]),
            "--eval-every", str(t["eval_every"]),
            "--num-envs", str(t["num_envs"]),
            "--collect-steps", str(t["collect_steps"]),
            "--updates-per-iter", str(t["updates_per_iter"]),
            "--batch", str(t["batch"]), "--fused-adam", "--fused-linear",
            "--ckpt-dir", ckpt_dir, "--seed", str(SEED)]
    report, wall, mm, by_route, adam = _run_counted(lambda: train_main(argv))
    iters, k = t["steps"], t["updates_per_iter"]
    per_iter = t["collect_steps"] * t["num_envs"]
    updating = sum((i + 1) * per_iter >= t["batch"] for i in range(iters))
    evals = iters // t["eval_every"]
    per_step = sum(r[4] for r in cfg["shapes"])
    acting = t["collect_steps"] * iters + spec.episode_length * evals
    want = {"pop_matmul": per_step * k * updating + 3 * acting,
            "pop_adam": cfg["adam"] * k * updating}
    want_routes = added(scaled(sac_dqn_step_routes(algo), k * updating),
                        scaled(served_batch_routes(), acting))
    launches = {"pop_matmul": mm, "pop_adam": adam}
    if launches != want or by_route != want_routes:
        raise AssertionError(f"{algo} train: launches {launches}, want "
                             f"{want}; by route {by_route}, want "
                             f"{want_routes}")
    if report.metrics is None or not all(
            torch.isfinite(v).all() for v in report.metrics.values()):
        raise AssertionError(f"{algo} train: losses not finite: "
                             f"{report.metrics}")
    replace = max(1, round(POPULATION * 0.3))
    moved = [sum(p != i for i, p in enumerate(lin))
             for _, lin in report.evolutions]
    if [it for it, _ in report.evolutions] != list(
            range(t["pbt_interval"], iters + 1, t["pbt_interval"])) \
            or replace not in moved:
        raise AssertionError(f"{algo} train: evolutions "
                             f"{report.evolutions}")
    mgr = CheckpointManager(ckpt_dir)
    fitness = mgr.peek_extra()["fitness"]
    if mgr.latest() != iters - 1 or fitness is None or \
            len(fitness) != POPULATION or not np.isfinite(fitness).all():
        raise AssertionError(f"{algo} train: checkpoint {mgr.latest()}, "
                             f"fitness {fitness}")
    log(f"{algo} train: {iters} iterations in {wall:.2f}s through the entry "
        f"point ({cfg['env']}, {POPULATION} members); launches {launches}, "
        f"by route {by_route}; evolves {report.evolutions}; best fitness "
        f"{report.best_fitness:+.2f}; metrics "
        f"{ {k: round(float(v.mean()), 4) for k, v in report.metrics.items()} }")
    trainer = report.trainer
    iter_ms = _sync_ms(trainer.env_iteration)
    share, busy_ms, busy_wall_ms = device_busy_share(trainer.env_iteration)
    log(f"{algo} train: {iter_ms:.2f} ms per iteration (collect "
        f"{t['collect_steps']} x {t['num_envs']} envs + {k} updates), one "
        f"more profiled: device busy {busy_ms:.2f} ms of {busy_wall_ms:.2f}"
        f" ms, share {'not measured' if share is None else f'{share:.4f}'}")

    requests = 16
    serve_argv = ["--algo", algo, "--env", cfg["env"], "--ckpt-dir",
                  ckpt_dir, "--ensemble", str(ENSEMBLE), "--mode",
                  cfg["mode"], "--fused-linear", "--batch", str(BATCH),
                  "--requests", str(requests), "--seed", str(SEED)]
    served, _, mm, by_route, _ = _run_counted(lambda: serve_main(serve_argv))
    want_routes = scaled(served_batch_routes(), requests + 2)
    if mm != 3 * (requests + 2) or by_route != want_routes:
        raise AssertionError(f"{algo} serve: pop_matmul launches {mm} by "
                             f"route {by_route}, want {want_routes}")
    members = served.server.set.members.tolist()
    if members[0] != int(np.argmax(fitness)):
        raise AssertionError(f"{algo} serve: the fittest member is not in "
                             f"slot 0: {members}")
    worst = unjudged = 0
    for obs, actions in served.batches:
        if algo == "dqn":
            unjudged += check_votes(served.server, obs, actions)
        else:
            worst = max(worst, check_answers(served.server, obs, actions,
                                             head=_plain_head("sac")))
    judged = requests * BATCH - unjudged
    if judged < 0.99 * requests * BATCH:
        raise AssertionError(f"dqn serve: {unjudged} near ties of "
                             f"{requests * BATCH} requests")
    log(f"{algo} serve ({cfg['mode']}): {served.requests} requests, "
        f"{served.req_per_s:.1f} req/s, p50 {served.p50_ms:.4f} ms p99 "
        f"{served.p99_ms:.4f} ms per batch of {BATCH}, {mm} pop_matmul "
        f"launches {by_route}, members {members}; answers == plain "
        f"ensemble" + (f" on {judged} of {requests * BATCH} requests "
                       f"({unjudged} near ties left unjudged)"
                       if algo == "dqn" else f", max abs err {worst:.3g}"))
    return {"launches": launches, "pop_matmul_launches_by_route":
            dict(by_route), "train_launches_by_route": want_routes,
            "seconds": wall, "iter_ms": iter_ms,
            "device_busy_share": share, "device_busy_ms": busy_ms,
            "busy_wall_ms": busy_wall_ms,
            "device_busy_share_unprofiled": (None if share is None
                                             else busy_ms / iter_ms),
            "best_fitness": report.best_fitness,
            "evolutions": report.evolutions,
            "serve": {"mode": cfg["mode"], "req_per_s": served.req_per_s,
                      "p50_ms": served.p50_ms, "p99_ms": served.p99_ms,
                      "launches": mm, "max_abs_err": worst,
                      "unjudged_near_ties": unjudged}}


def phase_torso():
    """DQN's Atari torso card (cuDNN, TF32 off) against CPU on the same
    weights: ``q_net_apply`` on TORSO["frames"] frames of 84x84x4, and one
    per-member DQN update (``F.conv2d`` and the stock Adam): the loss,
    Adam's moments (the gradients) and the parameters, the latter where
    the gradient is clear of Adam's eps in both (a gradient within 1e-7
    of 0 takes a step its rounding decides). Returns the numbers."""
    from repro_torch.rl import dqn
    from repro_torch.rl import networks as nets
    from repro_torch.tree import leaves, tree_map

    gen = torch.Generator().manual_seed(SEED + 11)
    state = dqn.init(gen, 0, TORSO["actions"], conv_torso=True)
    b, a = TORSO["frames"], TORSO["actions"]
    shape = (b, 84, 84, 4)
    batch = {"obs": torch.rand(shape, generator=gen),
             "action": torch.randint(0, a, (b,), generator=gen,
                                     dtype=torch.int32),
             "reward": torch.randn((b,), generator=gen),
             "next_obs": torch.rand(shape, generator=gen),
             "done": (torch.rand((b,), generator=gen) < 0.1).float()}
    cuda = lambda tree: tree_map(lambda x: x.to("cuda"), tree)
    q_cpu = nets.q_net_apply(state.q, batch["obs"])
    q_card = nets.q_net_apply(cuda(state.q), batch["obs"].to("cuda"))
    torch.cuda.synchronize()
    torch.testing.assert_close(q_card.cpu(), q_cpu, **TORSO_TOL)
    q_err = (q_card.cpu() - q_cpu).abs().max().item()
    q_share = tol_share(q_card.cpu(), q_cpu, TORSO_TOL)

    hypers = {"lr": 1e-4, "discount": 0.99}
    new_cpu, m_cpu = dqn.update(state, batch, hypers)
    new_card, m_card = dqn.update(cuda(state), cuda(batch), hypers)
    torch.cuda.synchronize()
    torch.testing.assert_close(m_card["loss"].cpu(), m_cpu["loss"],
                               **TORSO_TOL)
    # the gradient from each moment: mu = 0.1 g and nu = 0.001 g^2 after
    # Adam's first step
    from_moment = {"mu": lambda m: m / 0.1,
                   "nu": lambda v: torch.sqrt(v / 0.001)}
    grad_err = param_err = 0.0
    held = total = 0
    for f, grad in from_moment.items():
        for g, r in zip(leaves(getattr(new_card.opt, f)),
                        leaves(getattr(new_cpu.opt, f))):
            g, r = grad(g.cpu()), grad(r)
            torch.testing.assert_close(g, r, **STEP1_GRAD_TOL, msg=f)
            grad_err = max(grad_err, (g - r).abs().max().item())
    for p, r, mu, mur in zip(leaves(new_card.q), leaves(new_cpu.q),
                             leaves(new_card.opt.mu),
                             leaves(new_cpu.opt.mu)):
        mu = mu.cpu().abs()
        mur = mur.abs()
        keep = (torch.maximum(mu, mur) == 0) | \
            (torch.minimum(mu, mur) > 0.1 * 1e-7)
        torch.testing.assert_close(p.cpu()[keep], r[keep], rtol=1e-4,
                                   atol=1e-6)
        param_err = max(param_err, (p.cpu() - r)[keep].abs().max().item())
        held += int(keep.sum())
        total += keep.numel()
    if held < 0.99 * total:
        raise AssertionError(f"torso update: only {held} of {total} "
                             f"parameters clear of Adam's eps")
    q_dev = cuda(state.q)
    frames = batch["obs"].to("cuda")
    fwd_ms = graph_ms(lambda: nets.q_net_apply(q_dev, frames), reps=10,
                      iters=5)
    log(f"torso: q_net_apply on {b} frames of 84x84x4 card == CPU, max abs "
        f"err {q_err:.3g} ({q_share:.3g} of rtol 1e-4, atol 1e-5), "
        f"{fwd_ms * 1e3:.1f} us on the card; one member's update card == "
        f"CPU: loss {float(m_card['loss']):.6f}, gradients max abs err "
        f"{grad_err:.3g}, parameters {param_err:.3g} ({held} of {total} "
        f"held, the rest within 1e-7 of a zero gradient)")
    return {"q_max_abs_err": q_err, "q_share": q_share,
            "grad_max_abs_err": grad_err, "param_max_abs_err": param_err,
            "params_held": held, "params": total, "forward_ms": fwd_ms}


def phase_fig2_arm(algo):
    """One of Fig. 2's arms beside the TD3 one (the same dims: pendulum,
    the repo's width, B=256, 8 chained steps a call, N = 1, 8, 32): ms
    per member-update-step of the sequential arm (no kernel) and the
    vectorized one (FIG2_ARMS' pop_matmul and pop_adam launches a step),
    the median of FIG2_REPS synchronised calls each with their min and
    max, after a warm-up call of one step. Where the arm would pass its
    limit_s with FIG2_REPS calls at the largest N (judged from its time
    so far and its calls at the size before, times FIG2_HOST_SPREAD), the
    sequential arm's cell there is one call, and says so."""
    from repro_torch.core.hyperparams import sample_hypers
    from repro_torch.envs import make
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.pop_matmul import pop_matmul
    from repro_torch.pop import make_update
    from repro_torch.rl import get_algo, make_agent
    from repro_torch.tree import tree_map

    k, bsz = FIG2["num_steps"], FIG2["batch"]
    limit_s = FIG2_ARMS[algo]["limit_s"]
    per_step = FIG2_ARMS[algo]["launches"]
    agent = make_agent(algo, make("pendulum").spec, device="cuda")
    rows = {"sequential": {}, "vectorized": {}}
    t_start = time.perf_counter()
    for n in FIG2["sizes"]:
        state = agent.population_init(torch.Generator().manual_seed(SEED), n)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
        hypers = sample_hypers(gen, get_algo(algo).hyper_space, n)
        batches = (ppo_batches(gen, state, k, n, bsz) if algo == "ppo"
                   else rl_batches(gen, k, n, bsz))
        for backend in rows:
            update = make_update(agent, backend, num_steps=k)
            st = tree_map(torch.clone, state)
            make_update(agent, backend)(
                st, {key: v[0] for key, v in batches.items()}, hypers, gen)
            torch.cuda.synchronize()
            reps = FIG2_REPS
            if backend == "sequential" and n == max(FIG2["sizes"]):
                # the arm's time so far and what the last size's calls
                # would add: a sequential call costs about N member calls
                # of the size before, a vectorized one what it cost there
                last = max(rows[backend])
                ahead = FIG2_HOST_SPREAD * FIG2_REPS * (
                    rows[backend][last]["median_ms"] * n / last
                    + rows["vectorized"][last]["median_ms"]) / 1e3
                if time.perf_counter() - t_start + ahead > limit_s:
                    reps = 1
            times = []
            reset_counts(pop_matmul, pop_adam)
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                st, metrics = update(st, batches, hypers, gen)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
                if not all(torch.isfinite(v).all()
                           for v in metrics.values()):
                    raise AssertionError(f"fig2 {algo} ({backend}, N={n}):"
                                         f" non-finite metrics")
            launches = (pop_matmul.launches, pop_adam.launches)
            want = ((per_step[0] * k * reps, per_step[1] * k * reps)
                    if backend == "vectorized" else (0, 0))
            if launches != want:
                raise AssertionError(f"fig2 {algo} ({backend}, N={n}): "
                                     f"launches {launches}, want {want}")
            med = float(np.median(times))
            rows[backend][n] = {
                "median_ms": med, "min_ms": min(times),
                "max_ms": max(times), "calls": reps,
                "ms_per_member_update_step": med / (k * n)}
            log(f"fig2 {algo} {backend} N={n}: {med:.2f} ms a call of {k} "
                f"steps (median of {reps}, min {min(times):.2f}, max "
                f"{max(times):.2f}), {med / (k * n) * 1e3:.2f} us per "
                f"member-update-step"
                + ("" if reps == FIG2_REPS else
                   f"; one call only: with {FIG2_REPS} the arm would pass "
                   f"{limit_s:.0f} s"))
            del st
    lo, hi = min(FIG2["sizes"]), max(FIG2["sizes"])
    ratio = {b: by[hi]["median_ms"] / by[lo]["median_ms"]
             for b, by in rows.items()}
    seconds = time.perf_counter() - t_start
    log(f"fig2 {algo}: a call's time at N={hi} over N={lo}: vectorized "
        f"{ratio['vectorized']:.2f}x, sequential {ratio['sequential']:.2f}x"
        f"; the arm took {seconds:.1f} s")
    return {"algo": algo, "batch": bsz, "num_steps": k,
            "hidden": [256, 256], "reps": FIG2_REPS, "calls": rows,
            f"call_ratio_n{hi}_over_n{lo}": ratio, "seconds": seconds}


# ------------------------------------------------------------------ PPO
def ppo_layers(env):
    """(actor, value) layers of a PPO member on ``env``: (K, M, act) each;
    the actor's head is a tanh mean (continuous) or the logits."""
    cfg = PPO[env]
    trunk = ((cfg["obs"], 256, "relu"), (256, 256, "relu"))
    head = (256, cfg["act"], "none" if cfg["discrete"] else "tanh")
    return trunk + (head,), trunk + ((256, 1, "none"),)


def ppo_shapes(env):
    """The shape table of one PPO update step: the actor's 3 forwards and
    the value head's 3, each differentiated once (a first layer reads obs:
    no dx)."""
    actor, value = ppo_layers(env)
    return _shape_rows(actor, 1, "actor") + _shape_rows(value, 1, "value")


def ppo_routes(env, what):
    """pop_matmul launches of each route, by the wrapper's rule: one update
    or acting step (``"step"``: the actor's and the value head's layers,
    which must give PPO_STEP_ROUTES), or one net's 3 layers (``"net"``: an
    evaluation step, a served batch, a GAE value call; SERVED_BATCH_ROUTES).
    """
    actor, value = ppo_layers(env)
    if what == "step":
        return expect_routes(pop_matmul_routes(
            POPULATION, PPO_TRAIN["batch"],
            [(k, m, c) for _, k, m, _, c, _ in ppo_shapes(env)]),
            PPO_STEP_ROUTES, f"a ppo {env} update step")
    return expect_routes(pop_matmul_routes(
        ENSEMBLE, BATCH, [(k, m, 1) for k, m, _ in actor]),
        SERVED_BATCH_ROUTES, f"a ppo {env} actor forward")


def ppo_params(env):
    """Parameters a PPO member's one Adam step takes: actor, value head and
    (continuous) log_std."""
    p = lambda layers: sum(k * m + m for k, m, _ in layers)
    actor, value = ppo_layers(env)
    return p(actor) + p(value) + (0 if PPO[env]["discrete"]
                                  else PPO[env]["act"])


def ppo_batches(gen, state, k, n, bsz, obs=3, act=1, discrete=False):
    """``k`` steps of (N, B) on-policy minibatches on the card (pendulum's
    obs 3 and act 1 by default): the collected log-probs are the members'
    own by plain layers plus N(0, 0.1^2), so some ratios clip and some do
    not; values, advantages and returns standard normal."""
    from repro_torch.rl import ppo

    shape = (k, n, bsz)
    out = {"obs": torch.randn(shape + (obs,), generator=gen, device="cuda")}
    out["action"] = (
        torch.randint(0, act, shape, generator=gen, device="cuda",
                      dtype=torch.int32) if discrete else
        torch.randn(shape + (act,), generator=gen, device="cuda"))
    with torch.no_grad():
        logp = torch.stack([ppo._pop_log_prob_entropy(
            state.params, out["obs"][i], out["action"][i], fused=False)[0]
            for i in range(k)])
    out["log_prob"] = logp + 0.1 * torch.randn(shape, generator=gen,
                                               device="cuda")
    for key in ("value", "advantage", "return"):
        out[key] = torch.randn(shape, generator=gen, device="cuda")
    return out


def phase_ppo_kernels():
    """pop_matmul against its plain version at PPO_KM on both routes (every
    narrow shape also launched on the tiled route), N 1 and 8, B 1, 33, a
    minibatch and a rollout's 512 (the GAE value call), x broadcast or
    not, 3 activations, and under autograd; pop_adam at PPO's two (N=8, P);
    then each env's update-step shapes timed beside their bounds, the
    plain versions and the library calls. Returns the numbers."""
    from repro_torch.kernels.pop_matmul import (_launch, _route, pop_matmul,
                                                pop_matmul_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    worst = share = 0.0
    cases = 0
    want = dict.fromkeys(pop_matmul.launches_by_route, 0)
    reset_counts(pop_matmul)
    rollout = PPO_TRAIN["collect_steps"] * PPO_TRAIN["num_envs"]
    for n in (1, POPULATION):
        for bsz in (1, 33, PPO_TRAIN["batch"], rollout):
            for k, m in PPO_KM:
                routes = {_route(n, bsz, k, m), "tiled"}
                w = torch.randn((n, k, m), generator=gen,
                                device="cuda") / k ** 0.5
                b = torch.randn((n, m), generator=gen, device="cuda")
                xs = torch.randn((n, bsz, k), generator=gen, device="cuda")
                one = torch.randn((bsz, k), generator=gen, device="cuda")
                for x in (xs, one.unsqueeze(0).expand(n, bsz, k)):
                    for act in ("none", "relu", "tanh"):
                        ref = pop_matmul_plain(x, w, b, activation=act)
                        for route in sorted(routes):
                            y = _launch(x, w, b, act, route=route)
                            torch.cuda.synchronize()
                            torch.testing.assert_close(y, ref, **TOL)
                            worst = max(worst, (y - ref).abs().max().item())
                            share = max(share, tol_share(y, ref, TOL))
                            want[route] += 1
                            cases += 1
    by_route = dict(pop_matmul.launches_by_route)
    if by_route != want or sum(want.values()) != cases:
        raise AssertionError(f"ppo pop_matmul cases by route {by_route}, "
                             f"want {want}")
    grad_err, fwd_err, grad_share, grad_n = grad_cases(PPO_KM, gen)
    log(f"pop_matmul == plain at the PPO shapes on {cases} forward cases "
        f"((K,M) {list(PPO_KM)}, N 1/8, B 1/33/{PPO_TRAIN['batch']}/"
        f"{rollout}, x broadcast or not, 3 activations, narrow shapes on "
        f"both routes; by route {by_route}), max abs err {worst:.3g}; "
        f"backward (dx, dw, db) on {grad_n} cases, max abs err "
        f"{grad_err:.3g}")
    sizes = sorted({(POPULATION, ppo_params(env)) for env in PPO})
    adam_err, adam_share = adam_cases(gen, sizes)
    log(f"pop_adam == plain at {sizes}, max abs err {adam_err:.3g}, "
        f"{adam_share:.3g} of the tolerance")

    out = {"max_abs_err": max(worst, fwd_err), "grad_max_abs_err": grad_err,
           "adam_max_abs_err": adam_err, "share": max(share, grad_share),
           "adam_share": adam_share, "forward_cases": cases,
           "backward_cases": grad_n, "by_route": by_route}
    for env in PPO:
        rows = training_rows(ppo_shapes(env), gen, label=f"ppo {env} ")
        adam = [adam_row(gen, f"ppo {env}", POPULATION, ppo_params(env))]
        per_step = lambda key: sum(r[key] * r["launches_per_update_step"]
                                   for r in rows)
        out[env] = {
            "work": f"the 6 pop_matmul forwards and the 1 pop_adam launch "
                    f"of one ppo update step (N={POPULATION}, "
                    f"B={PPO_TRAIN['batch']}, {env}); device times, CUDA "
                    f"graph replay, L2-warm",
            "pop_matmul": {key: per_step(key) for key in
                           ("ms", "plain_ms", "bound_ms", "library_ms")},
            "pop_matmul_backward_ms": sum(r["backward_ms_per_step"]
                                          for r in rows),
            "pop_matmul_backward_bound_ms": sum(
                r["backward_bound_ms_per_step"] for r in rows),
            "pop_adam": {key: adam[0][key] for key in
                         ("ms", "plain_ms", "bound_ms", "library_ms")},
            "per_launch": rows, "pop_adam_per_launch": adam}
        log(f"ppo {env} update step on the card: pop_matmul forwards "
            f"{out[env]['pop_matmul']['ms'] * 1e3:.3f} us (bound "
            f"{out[env]['pop_matmul']['bound_ms'] * 1e3:.3f}), backward "
            f"bmm {out[env]['pop_matmul_backward_ms'] * 1e3:.3f} us, "
            f"pop_adam {out[env]['pop_adam']['ms'] * 1e3:.3f} us (bound "
            f"{out[env]['pop_adam']['bound_ms'] * 1e3:.3f})")
    return out


def phase_ppo_update_parity(env):
    """One full-width PPO population update (N=8, B=256) chained 4 times
    with every kernel and again with every plain version, from one state,
    batch stack and hypers: step-1 gradients (Adam's first moments / 0.1,
    the plain route on the kernel route's ReLU masks) and the parameters
    after 4 steps must agree, the first step must run the shape table's 6
    backwards, and every step 6 pop_matmul launches (4 tiled, 2 narrow)
    and 1 pop_adam."""
    from repro_torch.core.hyperparams import sample_hypers
    from repro_torch.core.vectorize import chain_steps
    from repro_torch.envs import make
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.pop_matmul import pop_matmul
    from repro_torch.rl import get_algo, make_agent, ppo
    from repro_torch.tree import leaves

    cfg = PPO[env]
    k_steps, n, bsz = 4, POPULATION, PPO_TRAIN["batch"]
    agent = make_agent("ppo", make(env).spec, device="cuda")
    state = agent.population_init(torch.Generator().manual_seed(SEED), n)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    hypers = sample_hypers(gen, get_algo("ppo").hyper_space, n)
    batches = ppo_batches(gen, state, k_steps, n, bsz, cfg["obs"],
                          cfg["act"], cfg["discrete"])
    first = {k: v[0] for k, v in batches.items()}
    rest = {k: v[1:] for k, v in batches.items()}
    want_backs = collections.Counter()
    for _, k, m, _, _, back in ppo_shapes(env):
        for grads, count in back:
            want_backs[(k, m, grads)] += count
    out, masks = {}, []
    for route, fused_linear, fused in (("kernels", True, None),
                                       ("plain", False, False)):
        update = ppo.make_population_update(fused_linear=fused_linear,
                                            fused=fused)
        reset_counts(pop_matmul, pop_adam)
        with kernel_relu_masks(masks, replay=not fused_linear) as masked:
            (s1, _), backs = backwards_of(
                lambda: update(state, first, hypers))
        if fused_linear and backs != want_backs:
            raise AssertionError(f"ppo {env} update: backwards "
                                 f"{dict(backs)}, the shape table says "
                                 f"{dict(want_backs)}")
        s4, metrics = chain_steps(update, k_steps - 1)(s1, rest, hypers)
        torch.cuda.synchronize()
        counts = (pop_matmul.launches, pop_adam.launches)
        want = (6 * k_steps, k_steps) if fused is None else (0, 0)
        by_route = dict(pop_matmul.launches_by_route)
        want_routes = scaled(ppo_routes(env, "step"),
                             k_steps if fused is None else 0)
        if counts != want or by_route != want_routes:
            raise AssertionError(f"ppo {env} update ({route}): launches "
                                 f"(pop_matmul, pop_adam) {counts}, want "
                                 f"{want}; by route {by_route}, want "
                                 f"{want_routes}")
        for name, v in metrics.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"ppo {env} update: non-finite {name}")
        out[route] = ([m / 0.1 for m in leaves(s1.opt.mu)],
                      leaves(s4.params))
    grad_err = param_err = share = 0.0
    for g, r in zip(*(out[k][0] for k in ("kernels", "plain"))):
        torch.testing.assert_close(g, r, **STEP1_GRAD_TOL)
        grad_err = max(grad_err, (g - r).abs().max().item())
        share = max(share, tol_share(g, r, STEP1_GRAD_TOL))
    for a, b in zip(*(out[k][1] for k in ("kernels", "plain"))):
        torch.testing.assert_close(a, b, rtol=0.0, atol=PARAMS_AFTER_4_ATOL)
        param_err = max(param_err, (a - b).abs().max().item())
    log(f"ppo {env} update parity, kernels vs plain (N={n}, B={bsz}, full "
        f"width): step-1 gradients max abs err {grad_err:.3g} "
        f"({share:.3g} of rtol 1e-4, atol 1e-6; {masks_text(masked)}), "
        f"parameters after {k_steps} steps {param_err:.3g} (atol "
        f"{PARAMS_AFTER_4_ATOL}); per step 6 pop_matmul launches "
        f"{ppo_routes(env, 'step')} and 1 pop_adam; backwards of step 1 "
        f"{dict(want_backs)}")
    return {"grad_max_abs_err": grad_err, "grad_share": share,
            "param_max_abs_err": param_err,
            "relu_mask_elements_differing": int(masked["differ"]),
            "pop_matmul_per_step": ppo_routes(env, "step"),
            "pop_adam_per_step": 1, "backwards_per_step": 6}


def phase_ppo_gae():
    """GAE on the card against the CPU on one rollout at the train phase's
    size (cartpole, 8 members, 64 steps x 8 envs), collected with half the
    envs 20 steps before the time limit, so it holds terminations and
    truncations: the GAE value call (3 pop_matmul launches) against its
    plain version on the CPU at TOL, then the advantages and returns from
    the same values at GAE_TOL, each member with its own discount and
    gae_lambda. Returns the numbers."""
    from repro_torch.configs.base import PopulationConfig
    from repro_torch.core.hyperparams import sample_hypers
    from repro_torch.data import compute_gae
    from repro_torch.envs import make
    from repro_torch.kernels.pop_matmul import pop_matmul
    from repro_torch.pop import PopTrainer
    from repro_torch.rl import get_algo, make_agent
    from repro_torch.tree import tree_map

    t = PPO_TRAIN
    env = make("cartpole")
    agent = make_agent("ppo", env.spec, device="cuda")
    trainer = PopTrainer(agent, PopulationConfig(size=POPULATION,
                                                 strategy="none"),
                         seed=SEED)
    engine = trainer.attach_rollout(
        env, num_envs=t["num_envs"], collect_steps=t["collect_steps"],
        batch_size=t["batch"], epochs=t["epochs"])
    vs = engine.vstate
    clock = vs.env_state["t"].clone()
    clock[:, ::2] = env.spec.episode_length - 20
    vs = vs._replace(env_state={**vs.env_state, "t": clock})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    hypers = sample_hypers(gen, get_algo("ppo").hyper_space, POPULATION)
    _, traj = engine.collector.collect(trainer.actors, vs, gen,
                                       t["collect_steps"], hypers,
                                       flat=False)
    bufs = engine.exp.add(engine.bufs, traj)
    d = bufs.data
    ends = {"terminations": int(d["done"].sum()),
            "truncations": int(d["truncated"].sum())}
    if min(ends.values()) == 0:
        raise AssertionError(f"ppo gae: the rollout holds {ends}")
    reset_counts(pop_matmul)
    adv, ret = engine.advantages(bufs, trainer.actors, hypers)
    torch.cuda.synchronize()
    if pop_matmul.launches_by_route != ppo_routes("cartpole", "net"):
        raise AssertionError(f"ppo gae: the value call launched "
                             f"{pop_matmul.launches_by_route}")
    n, steps, e = d["reward"].shape
    next_obs = d["next_obs"].flatten(1, 2)
    cpu = lambda tree: tree_map(lambda x: x.cpu(), tree)
    with torch.no_grad():
        next_v = agent.pop_value(trainer.actors, next_obs)
        next_v_cpu = agent.pop_value(cpu(trainer.actors), next_obs.cpu())
    torch.testing.assert_close(next_v.cpu(), next_v_cpu, **TOL)
    value_err = (next_v.cpu() - next_v_cpu).abs().max().item()
    args = (d["reward"], d["value"], next_v.reshape(n, steps, e), d["done"],
            torch.maximum(d["done"], d["truncated"]), hypers["discount"],
            hypers["gae_lambda"])
    card = compute_gae(*args)
    host = compute_gae(*cpu(args))
    if not all(torch.equal(a, b) for a, b in zip(card, (adv, ret))):
        raise AssertionError("ppo gae: the engine's advantages differ from "
                             "compute_gae on its own values")
    errs = {}
    for name, a, b in zip(("advantages", "returns"), card, host):
        torch.testing.assert_close(a.cpu(), b, **GAE_TOL, msg=name)
        errs[name] = ((a.cpu() - b).abs().max().item(),
                      tol_share(a.cpu(), b, GAE_TOL))
    log(f"ppo gae, card == CPU on one cartpole rollout ({n} members, "
        f"{steps} steps x {e} envs, {ends}): the value call (3 pop_matmul "
        f"launches) max abs err {value_err:.3g} (rtol=atol=1e-5); "
        + ", ".join(f"{k} max abs err {v[0]:.3g} ({v[1]:.3g} of rtol 1e-5, "
                    f"atol 1e-6)" for k, v in errs.items()))
    return {"value_max_abs_err": value_err, **ends,
            **{f"{k}_max_abs_err": v[0] for k, v in errs.items()},
            **{f"{k}_share": v[1] for k, v in errs.items()}}


def phase_ppo_train_serve(env, ckpt_dir):
    """The training entry point for PPO on ``env``: 8 members, PBT,
    ``--epochs 4``, with the launch counts set to 0 just before and read
    just after (6 pop_matmul launches an acting step and an update step, 3
    a GAE value call and an evaluation step, 1 pop_adam an update step);
    losses, fitness, evolutions and the checkpoint are checked, then ms per
    iteration and the busy share measured. Then the checkpoint is served
    through the serving entry point (pendulum ``mean``, cartpole
    ``vote``), counted the same way (3 pop_matmul launches a batch) and
    checked against the plain ensemble. Returns the numbers."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.envs import make
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    from repro_torch.rl import networks as nets

    cfg, t = PPO[env], PPO_TRAIN
    spec = make(env).spec
    argv = ["--algo", "ppo", "--env", env,
            "--population", str(POPULATION), "--steps", str(t["steps"]),
            "--pbt-interval", str(t["pbt_interval"]),
            "--eval-every", str(t["eval_every"]),
            "--num-envs", str(t["num_envs"]),
            "--collect-steps", str(t["collect_steps"]),
            "--batch", str(t["batch"]), "--epochs", str(t["epochs"]),
            "--fused-adam", "--fused-linear", "--ckpt-dir", ckpt_dir,
            "--seed", str(SEED)]
    report, wall, mm, by_route, adam = _run_counted(lambda: train_main(argv))
    iters = t["steps"]
    k = t["epochs"] * t["collect_steps"] * t["num_envs"] // t["batch"]
    evals = iters // t["eval_every"]
    acting = t["collect_steps"] * iters
    single = iters + spec.episode_length * evals   # GAE and evaluation
    want = {"pop_matmul": 6 * (acting + k * iters) + 3 * single,
            "pop_adam": k * iters}
    want_routes = added(scaled(ppo_routes(env, "step"), acting + k * iters),
                        scaled(ppo_routes(env, "net"), single))
    launches = {"pop_matmul": mm, "pop_adam": adam}
    if launches != want or by_route != want_routes:
        raise AssertionError(f"ppo {env} train: launches {launches}, want "
                             f"{want}; by route {by_route}, want "
                             f"{want_routes}")
    if report.metrics is None or not all(
            torch.isfinite(v).all() for v in report.metrics.values()):
        raise AssertionError(f"ppo {env} train: losses not finite: "
                             f"{report.metrics}")
    if report.trainer.state.opt.step.tolist() != [k * iters] * POPULATION:
        raise AssertionError(f"ppo {env} train: Adam steps "
                             f"{report.trainer.state.opt.step.tolist()}")
    replace = max(1, round(POPULATION * 0.3))
    moved = [sum(p != i for i, p in enumerate(lin))
             for _, lin in report.evolutions]
    if [it for it, _ in report.evolutions] != list(
            range(t["pbt_interval"], iters + 1, t["pbt_interval"])) \
            or replace not in moved:
        raise AssertionError(f"ppo {env} train: evolutions "
                             f"{report.evolutions}")
    mgr = CheckpointManager(ckpt_dir)
    fitness = mgr.peek_extra()["fitness"]
    if mgr.latest() != iters - 1 or fitness is None or \
            len(fitness) != POPULATION or not np.isfinite(fitness).all():
        raise AssertionError(f"ppo {env} train: checkpoint {mgr.latest()}, "
                             f"fitness {fitness}")
    log(f"ppo {env} train: {iters} iterations in {wall:.2f}s through the "
        f"entry point ({POPULATION} members, {k} chained updates an "
        f"iteration); launches {launches}, by route {by_route}; evolves "
        f"{report.evolutions}; best fitness {report.best_fitness:+.2f}; "
        f"metrics "
        f"{ {k: round(float(v.mean()), 4) for k, v in report.metrics.items()} }")
    trainer = report.trainer
    iter_ms = _sync_ms(trainer.env_iteration)
    share, busy_ms, busy_wall_ms = device_busy_share(trainer.env_iteration)
    log(f"ppo {env} train: {iter_ms:.2f} ms per iteration (collect "
        f"{t['collect_steps']} x {t['num_envs']} envs, GAE, {k} updates), "
        f"one more profiled: device busy {busy_ms:.2f} ms of "
        f"{busy_wall_ms:.2f} ms, share "
        f"{'not measured' if share is None else f'{share:.4f}'}")

    requests = 16
    serve_argv = ["--algo", "ppo", "--env", env, "--ckpt-dir", ckpt_dir,
                  "--ensemble", str(ENSEMBLE), "--mode", cfg["mode"],
                  "--fused-linear", "--batch", str(BATCH), "--requests",
                  str(requests), "--seed", str(SEED)]
    served, _, mm, by_route, _ = _run_counted(lambda: serve_main(serve_argv))
    want_routes = scaled(ppo_routes(env, "net"), requests + 2)
    if mm != 3 * (requests + 2) or by_route != want_routes:
        raise AssertionError(f"ppo {env} serve: pop_matmul launches {mm} by "
                             f"route {by_route}, want {want_routes}")
    members = served.server.set.members.tolist()
    if members[0] != int(np.argmax(fitness)):
        raise AssertionError(f"ppo {env} serve: the fittest member is not "
                             f"in slot 0: {members}")
    worst = unjudged = 0
    for obs, actions in served.batches:
        if cfg["discrete"]:
            unjudged += check_votes(
                served.server, obs, actions,
                scores=lambda p, x: nets.pop_mlp_apply(p["actor"], x,
                                                       fused=False))
        else:
            worst = max(worst, check_answers(
                served.server, obs, actions,
                head=lambda p, x: nets.pop_actor_apply(p["actor"], x,
                                                       fused=False)))
    judged = requests * BATCH - unjudged
    if judged < 0.99 * requests * BATCH:
        raise AssertionError(f"ppo {env} serve: {unjudged} near ties of "
                             f"{requests * BATCH} requests")
    log(f"ppo {env} serve ({cfg['mode']}): {served.requests} requests, "
        f"{served.req_per_s:.1f} req/s, p50 {served.p50_ms:.4f} ms p99 "
        f"{served.p99_ms:.4f} ms per batch of {BATCH}, {mm} pop_matmul "
        f"launches {by_route}, members {members}; answers == plain "
        f"ensemble" + (f" on {judged} of {requests * BATCH} requests "
                       f"({unjudged} near ties left unjudged)"
                       if cfg["discrete"] else f", max abs err {worst:.3g}"))
    return {"launches": launches, "pop_matmul_launches_by_route":
            dict(by_route), "train_launches_by_route": want_routes,
            "updates_per_iteration": k, "seconds": wall, "iter_ms": iter_ms,
            "device_busy_share": share, "device_busy_ms": busy_ms,
            "busy_wall_ms": busy_wall_ms,
            "device_busy_share_unprofiled": (None if share is None
                                             else busy_ms / iter_ms),
            "best_fitness": report.best_fitness,
            "evolutions": report.evolutions,
            "serve": {"mode": cfg["mode"], "req_per_s": served.req_per_s,
                      "p50_ms": served.p50_ms, "p99_ms": served.p99_ms,
                      "launches": mm, "max_abs_err": worst,
                      "unjudged_near_ties": unjudged}}


def _shape_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _shape_leaves(v)]
    return [tree]



# ------------------------------------------------- slice 13: acting engine
def hopper2d_bound(num, vec=False):
    """Least time (ms) and what bounds one hopper2d launch over ``num``
    envs: HOPPER2D_BYTES an env (27 floats read, 36 floats and a byte
    written; HOPPER2D_VEC_BYTES for the vector env's whole step) at the
    card's memory rate, against HOPPER2D_OPS an env at the fp32 rate."""
    nbytes = HOPPER2D_VEC_BYTES if vec else HOPPER2D_BYTES
    t_bytes = num * nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = num * HOPPER2D_OPS / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _rows_to(t, num):
    """``t``'s first ``num`` rows, or ``t`` repeated to ``num`` rows."""
    if num > t.shape[0]:
        t = t.repeat((-(-num // t.shape[0]),) + (1,) * (t.ndim - 1))
    return t[:num].contiguous()


def hopper2d_limits(state, action, gen, figures):
    """What limits hopper2d's kernels: from ptxas (``figures``, {label:
    {registers, spills, stack frame}}) and the SASS (LDL/STL: local
    memory), the occupancy a launch can reach, and the time by graph
    replay at HOPPER2D_SIZES (envs a member, N members) of the raw step
    kernel, of ``VecEnv.step`` on hopper2d, and of ``VecEnv.step`` on the
    generic path (the raw step, then the time limit, auto-reset and
    accounting as tensor code), each beside its bound."""
    import dataclasses

    from repro_torch.envs import make
    from repro_torch.kernels import build
    from repro_torch.kernels.hopper2d import (hopper2d_step,
                                              hopper2d_vec_step, kernel_info)
    from repro_torch.rollout.vecenv import VecEnv, VecEnvState

    n = HOPPER2D_KERNEL["members"]
    env = make("hopper2d")
    generic = dataclasses.replace(env, vec_step=None)
    local = sass_counts(build.library_path("hopper2d"),
                        r"\b(?:LDL|STL)\b")
    labels = kernel_labels(list(local))
    out = {"kernels": {}, "sizes": {}}
    for mangled, count in local.items():
        name = labels[mangled]
        route = "vec" if "vec" in name else "raw"
        info = kernel_info(route)
        info.update(figures.get(name, {}), ldl_stl=count)
        out["kernels"][route] = info
    props = torch.cuda.get_device_properties(0)
    slots = props.multi_processor_count * props.max_threads_per_multi_processor
    for e in HOPPER2D_SIZES:
        num = n * e
        x = [_rows_to(state[k], num) for k in ("pos", "th", "vel", "om")]
        a = _rows_to(action, num)
        vs = VecEnvState(
            env_state={k: _rows_to(state[k], num).reshape(
                (n, e) + tuple(state[k].shape[1:])) for k in state},
            obs=torch.zeros((n, e, 11), device="cuda"),
            **{f: torch.zeros((n, e), device="cuda", dtype=dt) for f, dt in (
                ("episode_return", torch.float32),
                ("episode_length", torch.int32),
                ("completed_episodes", torch.int32),
                ("completed_return_sum", torch.float32),
                ("completed_length_sum", torch.int32),
                ("last_episode_return", torch.float32))})
        acts = a.reshape(n, e, 3)
        v_in, draws, accounts = _hopper2d_vec_inputs(state, gen, num)
        row = {"raw_ms": graph_ms(lambda: hopper2d_step(*x, a)),
               "raw_bound_ms": hopper2d_bound(num)[0],
               "vec_ms": graph_ms(lambda: hopper2d_vec_step(
                   *v_in, a, *draws, accounts, 400)),
               "vec_bound_ms": hopper2d_bound(num, vec=True)[0]}
        for arm, which in (("step_ms", env), ("generic_step_ms", generic)):
            venv = VecEnv(which, e)
            row[arm] = graph_ms(lambda: venv.step(vs, acts, gen),
                                reps=10, iters=10, generator=gen)
        row["thread_slots_filled"] = {
            r: min(1.0, num * info.get("threads_per_env", 1) / slots)
            for r, info in out["kernels"].items()}
        out["sizes"][num] = row
        del x, a, vs, acts, v_in, draws, accounts
    return out


def _hopper2d_vec_inputs(state, gen, num):
    """The vector env's step inputs at ``num`` envs from ``state``: every
    fifth env at t = 399 (a time limit this step), every seventh torso at
    z = 0.5 (fallen), accounting tensors of random values, draws from
    ``gen``."""
    from repro_torch.envs.hopper2d import reset_draws

    x = [_rows_to(state[k], num).clone() for k in ("pos", "th", "vel", "om",
                                                   "t")]
    x[4][::5] = 399
    x[0][::7, 0, 1] = 0.5
    r = torch.randn((3, num), generator=gen, device="cuda")
    i = torch.randint(0, 400, (3, num), generator=gen, device="cuda",
                      dtype=torch.int32)
    accounts = (r[0], i[0], i[1], r[1], i[2], r[2])
    return x, reset_draws(gen, num, "cuda"), accounts


def phase_hopper2d_kernel(figures):
    """hopper2d's kernels against their plain versions at N = 8 members x
    4,096 envs, from states 50 random-action steps in (contacts active),
    with actions past the clip: the raw step, one step and three chained;
    the vector env's whole step, one step and three chained from
    _hopper2d_vec_inputs' state (time limits and falls), every output
    compared: equal to the bit but the named ones, which are held at
    rtol=atol=2e-4. Each timed by graph replay beside its plain version
    and its bound; then what limits them (hopper2d_limits, ``figures``
    its ptxas figures) at HOPPER2D_SIZES, beside the parent kernel's
    (HOPPER2D_BEFORE)."""
    from repro_torch.envs import make
    from repro_torch.envs.hopper2d import (CONTACTS, hopper2d_step_plain,
                                           hopper2d_vec_step_plain,
                                           reset_draws)
    from repro_torch.kernels.hopper2d import (ACCOUNTS, hopper2d_step,
                                              hopper2d_vec_step)

    h = HOPPER2D_KERNEL
    num = h["members"] * h["envs"]
    env = make("hopper2d")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    state, _ = env.reset(gen, num, "cuda")
    for _ in range(h["warm_steps"]):
        act = torch.rand((num, 3), generator=gen, device="cuda") * 2 - 1
        state, *_ = env.step(state, act, gen)
    keys = ("pos", "th", "vel", "om")
    x = [state[k].contiguous() for k in keys]
    lim = h["action_limit"]
    action = torch.rand((num, 3), generator=gen, device="cuda") * 2 * lim \
        - lim
    # a contact is active where a candidate point is below the ground:
    # the foot's two ends, the leg's bottom, the torso's two ends
    z = []
    for b, (ox, oz) in CONTACTS:
        th = state["th"][:, b]
        z.append(state["pos"][:, b, 1] + torch.sin(th) * ox
                 + torch.cos(th) * oz)
    in_contact = int((torch.stack(z, -1) < 0).any(-1).sum())
    reset_hopper2d_counts()
    worst = share = 0.0
    got, want = x, x
    for n_steps in (1, 2, 3):
        got = hopper2d_step(*got[:4], action)
        want = hopper2d_step_plain(*want[:4], action)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if w.dtype == torch.bool:
                if not torch.equal(g, w):
                    raise AssertionError(f"hopper2d: termination differs "
                                         f"after {n_steps} steps")
                continue
            worst = max(worst, (g - w).abs().max().item())
            share = max(share, tol_share(g, w, HOPPER2D_TOL))
        if n_steps in (1, 3):
            log(f"hopper2d raw step: {n_steps} step(s) at {num} envs, max "
                f"abs err {worst:.3g}, {share:.3g} of the tolerance")
    # the vector env's step, every output, chained
    names = ("pos", "th", "vel", "om", "t", "obs", "terminal_obs", "reward",
             "done", "truncated", "done_f", "truncated_f", *ACCOUNTS)
    v_in, (u_pos, u_th), accounts = _hopper2d_vec_inputs(state, gen, num)
    got = want = (*v_in, accounts)
    off_bit, ends = set(), {}
    for n_steps in (1, 2, 3):
        draws = reset_draws(gen, num, "cuda")
        got = hopper2d_vec_step(*got[:5], action, *draws, got[-1], 400)
        want = hopper2d_vec_step_plain(*want[:5], action, *draws, want[-1],
                                       400)
        torch.cuda.synchronize()
        for name, g, w in zip(names, (*got[:-1], *got[-1]),
                              (*want[:-1], *want[-1])):
            if torch.equal(g, w):
                continue
            if not g.is_floating_point():
                raise AssertionError(f"hopper2d vec step: {name} differs "
                                     f"after {n_steps} steps")
            off_bit.add(name)
            worst = max(worst, (g - w).abs().max().item())
            share = max(share, tol_share(g, w, HOPPER2D_TOL))
        if n_steps == 1:
            ends = {"done": int(want[8].sum()),
                    "truncated": int(want[9].sum())}
    off_bit = [n for n in names if n in off_bit]
    log(f"hopper2d vec step: 3 steps at {num} envs ({ends['done']} ended "
        f"at the first, {ends['truncated']} of them at the time limit): "
        f"bit for bit on {len(names) - len(off_bit)} of {len(names)} "
        f"outputs; off the bit {off_bit or 'none'} (max abs err "
        f"{worst:.3g}, {share:.3g} of rtol=atol=2e-4)")
    if share > 1.0:
        raise AssertionError(f"hopper2d kernels vs plain: {share:.3g} of "
                             f"rtol=atol=2e-4")
    if hopper2d_step.launches_by_route != {"raw": 3, "vec": 3}:
        raise AssertionError(f"hopper2d: launches "
                             f"{hopper2d_step.launches_by_route} for 3 "
                             f"steps of each")
    ms = graph_ms(lambda: hopper2d_step(*x, action))
    plain_ms = graph_ms(lambda: hopper2d_step_plain(*x, action), reps=2,
                        iters=5)
    vec = lambda: hopper2d_vec_step(*v_in, action, u_pos, u_th, accounts,
                                    400)
    vec_plain = lambda: hopper2d_vec_step_plain(*v_in, action, u_pos, u_th,
                                                accounts, 400)
    vec_ms = graph_ms(vec)
    vec_plain_ms = graph_ms(vec_plain, reps=2, iters=5)
    vec_plain_eager_ms = eager_ms(vec_plain, iters=5)
    bound_ms, bound_by = hopper2d_bound(num)
    vec_bound_ms, vec_bound_by = hopper2d_bound(num, vec=True)
    limits = hopper2d_limits(state, action, gen, figures)
    before = HOPPER2D_BEFORE
    for route, k in limits["kernels"].items():
        log(f"hopper2d {route} kernel: {k['registers']} registers a "
            f"thread, {k['threads_per_env']} threads an env, "
            f"{k['blocks_per_sm']} blocks of {k['threads_per_block']} an SM "
            f"at most, stack frame {k['stack_frame_bytes']} bytes, spills "
            f"{k['spill_store_bytes']}/{k['spill_load_bytes']} bytes, "
            f"{k['ldl_stl']} LDL/STL in its SASS (before: "
            f"{before['registers']} registers, 1 thread an env, stack frame "
            f"{before['stack_frame_bytes']} bytes, {before['ldl_stl']} "
            f"LDL/STL)")
    for n, r in limits["sizes"].items():
        log(f"hopper2d at {n} envs, us by graph replay (before -> after): "
            f"raw step {before['raw_us'][n]} -> {r['raw_ms'] * 1e3:.3f} "
            f"(bound {r['raw_bound_ms'] * 1e3:.3f}); vec step "
            f"{r['vec_ms'] * 1e3:.3f} (bound {r['vec_bound_ms'] * 1e3:.3f}, "
            f"{r['vec_ms'] / r['vec_bound_ms']:.1f}x); VecEnv.step "
            f"{before['generic_step_us'][n]} -> {r['step_ms'] * 1e3:.3f}, "
            f"on the generic path now {r['generic_step_ms'] * 1e3:.3f}; "
            f"{r['thread_slots_filled']['vec']:.3f} of the card's thread "
            f"slots")
    log(f"hopper2d at {num} envs ({in_contact} with a contact active): raw "
        f"kernel {ms * 1e3:.3f} us, plain {plain_ms * 1e3:.1f} us, bound "
        f"{bound_ms * 1e3:.3f} us ({bound_by}: {HOPPER2D_BYTES} B and "
        f"{HOPPER2D_OPS} operations an env); vec kernel "
        f"{vec_ms * 1e3:.3f} us, plain {vec_plain_ms * 1e3:.1f} us (graph "
        f"replay) and {vec_plain_eager_ms:.2f} ms eager, bound "
        f"{vec_bound_ms * 1e3:.3f} us ({vec_bound_by}: "
        f"{HOPPER2D_VEC_BYTES} B an env)")
    return {"envs": num, "in_contact": in_contact, "ends": ends,
            "max_abs_err": worst, "max_err_over_tolerance": share,
            "off_the_bit": off_bit, "ms": vec_ms, "plain_ms": vec_plain_ms,
            "plain_eager_ms": vec_plain_eager_ms, "bound_ms": vec_bound_ms,
            "bound_by": vec_bound_by,
            "raw": {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by},
            "limits": limits}


def _epoch_launches(trainer):
    """Kernel launches of a trainer's fused epochs: each captured graph's
    launches times its replays, plus its warm-up's (eager) launches."""
    out = {"pop_matmul": 0, "pop_adam": 0, "hopper2d": 0, "hopper2d_vec": 0}
    for fn in trainer._epochs.values():
        for k in out:
            out[k] += (fn.warmup_launches[k]
                       + fn.captured_launches[k] * fn.replays)
    return out


def _fused_trainer(algo, env_name, strategy, *, num_envs, policy_lag=None,
                   chunk_steps=None, cfg=None, ckpt=None, telemetry=None):
    from repro_torch.configs.base import PopulationConfig
    from repro_torch.envs import make
    from repro_torch.pop import PopTrainer
    from repro_torch.rl import get_algo, make_agent

    f = cfg or FUSED
    env = make(env_name)
    pcfg = PopulationConfig(
        size=f["population"], strategy=strategy, backend="vectorized",
        num_steps=f["updates"], pbt_interval=f["pbt_interval"],
        fitness_window=10, hyper_space=get_algo(algo).hyper_space)
    tr = PopTrainer(make_agent(algo, env.spec, device="cuda"), pcfg,
                    seed=SEED, checkpoint_dir=ckpt, telemetry=telemetry)
    kw = dict(num_envs=num_envs, collect_steps=f["collect_steps"],
              eval_envs=f["eval_envs"], eval_steps=f["eval_steps"],
              policy_lag=policy_lag, chunk_steps=chunk_steps)
    if algo == "ppo":
        tr.attach_rollout(env, batch_size=f["ppo_batch"],
                          epochs=f["ppo_epochs"], **kw)
    else:
        tr.attach_rollout(env, batch_size=f["batch"],
                          buffer_capacity=4 * num_envs * f["collect_steps"],
                          **kw)
    return tr


def _tree_err(a, b, tol=FUSED_TOL):
    """(bitwise equal, max abs difference, share of ``tol``) over two
    trees' leaves."""
    from repro_torch.tree import leaves

    la, lb = leaves(a), leaves(b)
    if len(la) != len(lb):
        raise AssertionError(f"trees of {len(la)} and {len(lb)} leaves")
    same, err, share = True, 0.0, 0.0
    for x, y in zip(la, lb):
        same = same and torch.equal(x, y)
        if x.numel():
            d = (x.double() - y.double()).abs().max().item()
            err = max(err, d)
            if x.is_floating_point():
                share = max(share, tol_share(x.double(), y.double(),
                                             tol))
            elif d:             # integers (counts, lineage) must be equal
                share = float("inf")
    return same, err, share


def phase_fused_epochs():
    """The fused train-evolve epoch captured as a CUDA graph against the
    eager loop from the same seed: TD3, SAC and PPO on hopper2d and DQN
    on cartpole with PBT, TD3 with CEM; FUSED's epochs in FUSED_SEQUENCE
    (capture, replay, eager, replay), every replay under
    set_sync_debug_mode("error"), the last from the state the eager epoch
    left, copied into the graph's static inputs. State, hypers,
    buffers, fitness window and lineage compared; each capture's node
    count, capture time and private pool logged."""
    f = FUSED
    rows = {}
    for algo, env_name, strategy in FUSED_RUNS:
        name = f"{algo}_{env_name}_{strategy}"
        t0 = time.perf_counter()
        eager = _fused_trainer(algo, env_name, strategy,
                               num_envs=f["num_envs"])
        fused = _fused_trainer(algo, env_name, strategy,
                               num_envs=f["num_envs"])
        iters = f["pbt_interval"] * len(FUSED_SEQUENCE)
        lineage = {"eager": [], "fused": []}
        hook = lambda k: (lambda it, m, s, fit, lin: lin is not None
                          and lineage[k].append(lin))
        eager.run_env_loop(iters, eval_every=f["eval_every"],
                           on_iter=hook("eager"))
        torch.cuda.synchronize()
        t_eager = time.perf_counter() - t0
        t_first = t_warm = t_mixed = 0.0
        for e, kind in enumerate(FUSED_SEQUENCE):
            t0 = time.perf_counter()
            # every replay (from the second fused epoch on) runs with a
            # host sync an error
            if kind == "fused" and e:
                torch.cuda.set_sync_debug_mode("error")
            try:
                fused.run_env_loop(f["pbt_interval"],
                                   eval_every=f["eval_every"],
                                   on_iter=hook("fused"),
                                   fused=kind == "fused")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if not e:
                t_first = dt
            elif kind == "fused" and not t_warm:
                t_warm = dt
            elif kind == "fused":
                t_mixed = dt
        checks = {
            "state": _tree_err(eager.state, fused.state),
            "hypers": _tree_err(eager.hypers, fused.hypers),
            "buffers": _tree_err(eager.rollout.bufs, fused.rollout.bufs),
            "env_states": _tree_err(eager.rollout.vstate,
                                    fused.rollout.vstate),
            "strategy": _tree_err(eager.strategy.export_state(),
                                  fused.strategy.export_state()),
            "last_fitness": _tree_err(eager.last_fitness,
                                      fused.last_fitness),
            "lineage": _tree_err(lineage["eager"], lineage["fused"]),
        }
        worst = max(c[2] for c in checks.values())
        if worst > 1.0 or len(lineage["fused"]) != len(FUSED_SEQUENCE) or \
                eager.step_count != fused.step_count or \
                len(eager._window) != len(fused._window):
            raise AssertionError(f"fused {name}: captured vs eager "
                                 f"{checks}, lineages {lineage}")
        bitwise = all(c[0] for c in checks.values())
        (fn,) = fused._epochs.values()
        if fn.replays != FUSED_SEQUENCE.count("fused"):
            raise AssertionError(f"fused {name}: {fn.replays} replays of "
                                 f"one capture for {FUSED_SEQUENCE}")
        launches = _epoch_launches(fused)
        if env_name == "hopper2d":
            expect_vec_route(f"fused {name}", launches)
        rows[name] = {
            "bitwise": bitwise,
            "max_abs_err": max(c[1] for c in checks.values()),
            "max_err_over_tolerance": worst,
            "graph_nodes": fn.node_count(),
            "capture_s": fn.capture_seconds, "pool_bytes": fn.pool_bytes,
            "captured_launches": fn.captured_launches,
            "replays": fn.replays, "launches": launches,
            "eager_s": t_eager, "first_epoch_s": t_first,
            "warm_epoch_s": t_warm, "after_eager_epoch_s": t_mixed}
        log(f"fused {name}: captured == eager over {len(FUSED_SEQUENCE)} "
            f"epochs {FUSED_SEQUENCE} "
            f"({'bit for bit' if bitwise else 'within rtol=atol=1e-5'}, "
            f"max abs err {rows[name]['max_abs_err']:.3g}); graph "
            f"{rows[name]['graph_nodes']} nodes, captured in "
            f"{fn.capture_seconds:.2f}s, pool {fn.pool_bytes / 2**20:.1f} "
            f"MiB, {fn.captured_launches} launches a replay, {fn.replays} "
            f"replays; warm epoch under sync debug 'error' in "
            f"{t_warm:.3f}s, after an eager epoch {t_mixed:.3f}s (first, "
            f"with warm-up and capture, "
            f"{t_first:.2f}s; eager {iters} iterations {t_eager:.2f}s)")
    return rows


def _kernel_events(fn):
    """One synchronised ``fn()`` call under torch.profiler, with the
    port's burst of throwaway launches (``profiler_burst``) at each end of
    the session, which a late session loses in place of the window's
    (ROADMAP §3, fault 8). Returns (wall ms, [(stream, start us, end us,
    name)] of the window's device work: kernels, copies and fills, kept:
    (k, n)): of the window's n launches (a kernel launch, or a graph
    launch, counted as its kernels in the trace), k have their kernels in
    the trace, matched by correlation id; a graph launch with none counts
    as one lost. Logs k of n, so every share printed after it says what
    its window kept."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.telemetry.run import profiler_burst

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiler_burst()
        with record_function("chip_smoke_window"):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        profiler_burst()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text()).get("traceEvents", [])
    (span,) = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in trace if e.get("name") == "chip_smoke_window"
               and e.get("cat") == "user_annotation"]
    calls = [e for e in trace
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and span[0] <= float(e["ts"]) <= span[1]]
    mine = {e.get("args", {}).get("correlation") for e in calls}
    device = [e for e in trace if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and e.get("args", {}).get("correlation") in mine]
    kernels = collections.Counter(e["args"]["correlation"] for e in device
                                  if e["cat"] == "kernel")
    kept = n = 0
    lost = []               # the lost launches' places in the window
    for e in sorted(calls, key=lambda e: float(e["ts"])):
        name, corr = e.get("name", ""), e.get("args", {}).get("correlation")
        if "LaunchKernel" in name:
            n += 1
            kept += bool(kernels[corr])
        elif "GraphLaunch" in name:
            n += max(1, kernels[corr])
            kept += kernels[corr]
        else:
            continue
        if not kernels[corr]:
            lost.append(n - 1)
    events = [(e.get("args", {}).get("stream"), float(e["ts"]),
               float(e["ts"]) + float(e.get("dur", 0)), e.get("name", ""))
              for e in device]
    log(f"profile window: {kept} of its {n} kernels kept in the trace"
        + ("" if kept == n else f" (lost: launches {lost[0]}-{lost[-1]} "
           f"in the window's order, {len(lost)} of them); its busy share "
           f"is not measured"))
    return wall, events, (kept, n)


def _union(spans):
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _busy_and_overlap(fn):
    """One profiled ``fn()``: (busy share: the union of the kernels' spans
    over the wall time, kernel ms, wall ms, overlap share: the part of the
    acting stream's kernel time (the stream that runs ``hopper2d``) spent
    while another stream runs a kernel, or None with one stream)."""
    wall, events, (kept, n) = _kernel_events(fn)
    if not events or kept < n:
        return None, 0.0, wall, None
    busy = _union([(s, e) for _, s, e, _ in events])
    acting = {st for st, _, _, name in events if "hopper2d" in name}
    share = busy / (wall * 1e3)
    streams = {st for st, *_ in events}
    if len(acting) != 1 or len(streams) < 2:
        return share, busy / 1e3, wall, None
    (act,) = acting
    others = sorted((s, e) for st, s, e, _ in events if st != act)
    mine = [(s, e) for st, s, e, _ in events if st == act]
    covered = 0.0
    for s, e in mine:
        for os_, oe in others:
            if oe <= s:
                continue
            if os_ >= e:
                break
            covered += min(e, oe) - max(s, os_)
    mine_total = sum(e - s for s, e in mine)
    return share, busy / 1e3, wall, (covered / mine_total
                                     if mine_total else None)


def phase_acting_engine():
    """TD3 on hopper2d at GPU-sim scale (the JAX package's acting sweep's
    shape, ACTING): for 256, 1,024 and 4,096 envs a member, K iterations
    with a host read of each iteration's episode count, timed as the
    median of ACTING's rounds with min and max, for the eager serial
    loop, the fused epoch (one graph replay for the K iterations, the
    reads after it) and policy_lag=1; the 4,096-env serial arm again with
    chunk_steps 2, bit for bit against the unchunked one. Each arm's ms
    per iteration, env steps/s per member and busy share (one profiled
    round); lag 1 also the share of acting's kernel time that overlaps
    another stream's kernels. At 4,096 envs lag 1 runs chunked too, bit
    for bit against lag 1 unchunked (the slot in flight included)."""
    a = ACTING
    cfg = dict(population=a["population"], updates=a["updates"],
               pbt_interval=a["iters"], collect_steps=a["collect_steps"],
               eval_envs=1, eval_steps=1, batch=a["batch"])
    rows = {}
    launches = {"pop_matmul": 0, "pop_adam": 0, "hopper2d": 0,
                "hopper2d_vec": 0}
    for num_envs in a["envs"]:
        arms = {"eager": dict(), "fused": dict(fused=True),
                "lag1": dict(policy_lag=1)}
        if num_envs == max(a["envs"]):
            arms["chunked"] = dict(chunk_steps=a["chunk_steps"])
            arms["lag1_chunked"] = dict(policy_lag=1,
                                        chunk_steps=a["chunk_steps"])
        trainers, rounds = {}, {}
        for arm, kw in arms.items():
            fused = kw.pop("fused", False)
            tr = _fused_trainer("td3", "hopper2d", "none", num_envs=num_envs,
                                cfg=cfg, **kw)
            reads = []

            def one_round(tr=tr, fused=fused, reads=reads):
                tr.run_env_loop(
                    a["iters"], eval_every=0, fused=fused,
                    on_iter=lambda it, m, s, fit, lin: reads.append(
                        int(s["episodes"].sum())))
                torch.cuda.synchronize()

            trainers[arm], rounds[arm] = tr, one_round
        from repro_torch.kernels import launch_counts
        before = launch_counts()
        for fn in rounds.values():          # warm: builds, capture, fill
            fn()
        times = {arm: [] for arm in arms}
        for r in range(a["rounds"]):
            order = list(arms)[r % len(arms):] + list(arms)[:r % len(arms)]
            for arm in order:
                t0 = time.perf_counter()
                rounds[arm]()
                times[arm].append((time.perf_counter() - t0) * 1e3
                                  / a["iters"])
        view = lambda t: (t.state, t.rollout.bufs, t.rollout.vstate,
                          (getattr(t.rollout, "_pending", None)
                           or ((),))[0])
        bitwise = set()
        for chunked, whole in (("chunked", "eager"), ("lag1_chunked",
                                                      "lag1")):
            if chunked not in arms:
                continue
            same, err, _ = _tree_err(view(trainers[whole]),
                                     view(trainers[chunked]))
            if not same:
                raise AssertionError(f"acting {num_envs}: {chunked} != "
                                     f"{whole} (max abs err {err})")
            bitwise.add(chunked)
        cell = {}
        for arm in arms:
            share, busy_ms, wall_ms, overlap = _busy_and_overlap(rounds[arm])
            ts = sorted(times[arm])
            med = ts[len(ts) // 2]
            cell[arm] = {
                "ms_per_iter": med, "min_ms": ts[0], "max_ms": ts[-1],
                "env_steps_per_s_per_member":
                    a["collect_steps"] * num_envs / (med / 1e3),
                "device_busy_share": share, "device_busy_ms": busy_ms,
                "profiled_wall_ms": wall_ms}
            if arm.startswith("lag1"):
                cell[arm]["overlap_share"] = overlap
            if arm in bitwise:
                cell[arm]["bitwise_vs_unchunked"] = True
            log(f"acting {num_envs} envs/member {arm}: {med:.2f} ms per "
                f"iteration (min {ts[0]:.2f}, max {ts[-1]:.2f}), "
                f"{cell[arm]['env_steps_per_s_per_member']:.0f} env steps/s "
                f"per member, busy share "
                f"{'not measured' if share is None else f'{share:.4f}'}"
                + (f", acting overlapped {overlap}"
                   if arm.startswith("lag1") else ""))
        cell["fused"]["graph_nodes"] = [
            e.node_count() for e in trainers["fused"]._epochs.values()]
        log(f"acting {num_envs} envs/member fused: graph "
            f"{cell['fused']['graph_nodes']} nodes")
        cell["fused_speedup"] = (cell["eager"]["ms_per_iter"]
                                 / cell["fused"]["ms_per_iter"])
        cell["lag1_speedup"] = (cell["eager"]["ms_per_iter"]
                                / cell["lag1"]["ms_per_iter"])
        # the wrappers count eager launches and, once, each captured launch
        # as the capture records it; a replay launches the captured ones
        # again without counting
        now = launch_counts()
        for k in launches:
            launches[k] += now[k] - before[k] + sum(
                e.captured_launches[k] * (e.replays - 1)
                for e in trainers["fused"]._epochs.values())
        rows[num_envs] = cell
    expect_vec_route("acting engine", launches)
    return rows, launches


def phase_acting_cli(ckpt_root):
    """The train CLI on hopper2d with each acting-engine flag (ACTING_CLI:
    --fused-epoch for TD3, --chunk-steps 2 for PPO, --policy-lag 1 for
    TD3), counted as the train phase (a fused run's graph launches as the
    captured ones times the replays); then each checkpoint served through
    the serve CLI and answers held to the plain ensemble."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    from repro_torch.rl import networks as nets
    from repro_torch.tree import leaves

    c = ACTING_CLI
    rows = {}
    for name, (algo, flags, mode) in c["runs"].items():
        ckpt_dir = str(Path(ckpt_root) / name)
        argv = ["--algo", algo, "--env", "hopper2d", "--population",
                str(POPULATION), "--steps", str(c["steps"]),
                "--pbt-interval", str(c["pbt_interval"]), "--eval-every",
                str(c["eval_every"]), "--num-envs", str(c["num_envs"]),
                "--collect-steps", str(c["collect_steps"]), "--fused-adam",
                "--fused-linear", "--ckpt-dir", ckpt_dir, "--seed",
                str(SEED), *flags]
        reset_hopper2d_counts()
        report, wall, mm, _, adam = _run_counted(lambda: train_main(argv))
        launches = {"pop_matmul": mm, "pop_adam": adam, **hopper2d_counts()}
        for fn in report.trainer._epochs.values():
            for k in launches:
                launches[k] += fn.captured_launches[k] * (fn.replays - 1)
        expect_vec_route(f"acting CLI {name}", launches)
        evolved = [it for it, _ in report.evolutions]
        if evolved != list(range(c["pbt_interval"], c["steps"] + 1,
                                 c["pbt_interval"])) or \
                report.metrics is None or not all(
                    torch.isfinite(v).all() for v in report.metrics.values()):
            raise AssertionError(f"acting CLI {name}: evolutions "
                                 f"{report.evolutions}, metrics "
                                 f"{report.metrics}")
        if CheckpointManager(ckpt_dir).latest() != c["steps"] - 1:
            raise AssertionError(f"acting CLI {name}: no checkpoint at the "
                                 f"last step")
        pending = None
        if "--policy-lag" in flags:
            # the last save landed with the next collect in flight on the
            # side stream: its rollout tree must hold that collect's whole
            # env states, read here after the card has finished
            engine = report.trainer.rollout
            pending = engine._pending is not None
            torch.cuda.synchronize()
            saved = CheckpointManager(ckpt_dir).restore_aux(
                "rollout", engine.export_state())
            if not pending or not all(
                    np.array_equal(a, b.cpu().numpy()) for a, b in
                    zip(leaves(saved), leaves(engine.export_state()))):
                raise AssertionError(f"acting CLI {name}: the last "
                                     f"checkpoint's rollout tree != the "
                                     f"engine's after the pending collect "
                                     f"(pending {pending})")
        if min(launches.values()) == 0:
            raise AssertionError(f"acting CLI {name}: launches {launches}")
        serve_argv = ["--algo", algo, "--env", "hopper2d", "--ckpt-dir",
                      ckpt_dir, "--ensemble", str(ENSEMBLE), "--mode", mode,
                      "--fused-linear", "--batch", str(BATCH), "--requests",
                      str(c["requests"]), "--seed", str(SEED)]
        served, _, smm, _, _ = _run_counted(lambda: serve_main(serve_argv))
        head = (None if algo == "td3" else
                lambda p, x: nets.pop_actor_apply(p["actor"], x,
                                                  fused=False))
        worst = max(check_answers(served.server, obs, actions, head=head,
                                  act_dim=3)
                    for obs, actions in served.batches)
        rows[name] = {"algo": algo, "flags": flags, "seconds": wall,
                      "ms_per_iter": wall * 1e3 / c["steps"],
                      "launches": launches, "evolutions": report.evolutions,
                      "best_fitness": report.best_fitness,
                      "checkpoint_during_pending_collect": pending,
                      "serve": {"mode": mode, "launches": smm,
                                "req_per_s": served.req_per_s,
                                "max_abs_err": worst}}
        log(f"acting CLI {name} ({algo} {' '.join(flags)}): {c['steps']} "
            f"iterations in {wall:.2f}s, launches {launches}, evolves at "
            f"{evolved}, best fitness {report.best_fitness:+.2f}"
            f"{'; the last checkpoint, saved with a collect in flight, == the engine state after it' if pending else ''}; served "
            f"({mode}) {served.requests} requests, {smm} pop_matmul "
            f"launches, answers == plain ensemble (max abs err "
            f"{worst:.3g})")
    return rows


# ------------------------------- slice 14: frontends, CEM over an LM
def _frontend_batch(cfg, gen, s):
    """One sequence of ``s`` random tokens and its frontend's inputs:
    frame embeddings (musicgen) or patch embeddings (pixtral) drawn from
    a unit normal, a hidden state's scale."""
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, s),
                                     generator=gen, device="cuda")}
    rows = (s if cfg.frontend == "audio_frames"
            else cfg.num_frontend_positions)
    key = "embeds" if cfg.frontend == "audio_frames" else "patch_embeds"
    batch[key] = torch.randn((1, rows, cfg.d_model), generator=gen,
                             device="cuda")
    return batch


def phase_frontend_parity():
    """musicgen-medium and pixtral-12b at full width with 2 layers in
    float32, weights drawn on the card and copied to the CPU, a 384-token
    sequence with random frame or patch embeddings: the serve step's
    prefill (the last logits and every decode-state leaf; musicgen fed its
    frames, pixtral its patches, which the serve step ignores), the
    stateless forward (every logit; pixtral's patches spliced over its
    first 256 positions) and ``lm_loss`` with its mask, card (kernels)
    against CPU (plain versions); each card pass 2 ``flash_attention``
    launches on the float32 route. Then the mask on the card: pixtral's
    loss is the same bits with the labels under the patches changed.
    Returns {arch: (max abs err, share of the tolerance)}."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import lm
    from repro_torch.tree import leaves, tree_map

    out = {}
    for arch in FRONTENDS:
        t0 = time.perf_counter()
        cfg = _lm_config(arch, num_layers=FRONTEND_PARITY_LAYERS,
                         dtype="float32")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
        params = lm.init_params(gen, cfg)
        s = FRONTEND_PARITY_SEQ
        batch = _frontend_batch(cfg, gen, s)
        cpu_params = tree_map(lambda t: t.cpu(), params)
        cpu_batch = {k: v.cpu() for k, v in batch.items()}
        step = lm.make_serve_step(cfg)
        worst = share = 0.0
        launches = {}

        def hold(got, want, what):
            nonlocal worst, share
            got = got.cpu()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{arch} parity: non-finite {what}")
            torch.testing.assert_close(got, want, **PATH_TOL,
                                       msg=lambda m: f"{arch} {what}: {m}")
            worst = max(worst, (got - want).abs().max().item())
            share = max(share, tol_share(got, want, PATH_TOL))

        def counted(name, fn):
            reset_counts(flash_attention)
            result = fn()
            torch.cuda.synchronize()
            launches[name] = dict(flash_attention.launches_by_route)
            return result

        logits, state = counted("prefill", lambda: step(
            params, batch, lm.init_decode_state(cfg, 1, s + 1,
                                                device="cuda"), 0))
        cpu_logits, cpu_state = step(
            cpu_params, cpu_batch, lm.init_decode_state(cfg, 1, s + 1), 0)
        hold(logits[:, -1], cpu_logits[:, -1], "prefill's last logits")
        pairs = list(zip(leaves(state), leaves(cpu_state)))
        for got, want in pairs:
            hold(got, want, "decode state")
        del state, cpu_state
        logits, _ = counted("stateless",
                            lambda: lm.forward(params, cfg, batch))
        cpu_logits, _ = lm.forward(cpu_params, cfg, cpu_batch)
        hold(logits, cpu_logits, "stateless logits")
        with torch.no_grad():
            loss, _ = counted("loss", lambda: lm.lm_loss(params, cfg, batch))
            cpu_loss, _ = lm.lm_loss(cpu_params, cfg, cpu_batch)
            hold(loss, cpu_loss, "lm_loss")
            if not loss.item() > 0:
                raise AssertionError(f"{arch}: lm_loss {loss.item()}, as "
                                     f"if every label were masked")
            masked = "no mask"
            if cfg.frontend == "vision_patches":
                npos = cfg.num_frontend_positions
                moved = dict(batch, tokens=batch["tokens"].clone())
                moved["tokens"][:, 1:npos] = (
                    moved["tokens"][:, 1:npos] + 1) % cfg.vocab_size
                again, _ = lm.lm_loss(params, cfg, moved)
                if not torch.equal(again, loss):
                    raise AssertionError(f"{arch}: the loss moved with the "
                                         f"labels under the patches")
                masked = (f"the labels under the {npos} patch positions "
                          f"masked (the loss the same bits with them "
                          f"changed)")
        want = {"bf16_mma": 0, "f32_fma": FRONTEND_PARITY_LAYERS}
        if any(r != want for r in launches.values()):
            raise AssertionError(f"{arch} parity: flash_attention launches "
                                 f"by route {launches}, want {want} each")
        log(f"{arch} with {FRONTEND_PARITY_LAYERS} layers at full width, "
            f"fp32, {s} tokens with random "
            f"{'frames' if cfg.frontend == 'audio_frames' else 'patches'}: "
            f"card == CPU on the prefill's last logits and {len(pairs)} "
            f"state leaves, every stateless logit and lm_loss "
            f"({loss.item():.6f}; {masked}); flash_attention launches "
            f"{launches}; max abs err {worst:.3g}, {share:.3g} of the "
            f"tolerance; {time.perf_counter() - t0:.1f} s")
        out[arch] = (worst, share)
        del params, cpu_params, logits, cpu_logits
        gc.collect()
        torch.cuda.empty_cache()
    return out


def pop_adam_in_place_vs_plain(args, extra, tol, label):
    """``pop_adam(*args, **extra, inplace=True)`` on (N, P) buffers too
    large for an out-of-place result beside them, held to the plain
    version on copies of their first and last 2^24 columns: Adam's step
    p - p' and both moments at ``tol``. Returns (max abs error, share of
    the tolerance)."""
    from repro_torch.kernels.pop_adam import pop_adam, pop_adam_plain

    params, _, mu, nu, lr, step = args
    p = params.shape[1]
    chunk = min(1 << 24, p)
    ends = [slice(0, chunk), slice(p - chunk, p)]
    saved = [[t[:, cols].clone() for t in args[:4]] for cols in ends]
    pop_adam(*args, **extra, inplace=True)
    worst = share = 0.0
    for cols, ins in zip(ends, saved):
        want = pop_adam_plain(*ins, lr, step, **extra)
        for name, g, r in zip(("step", "mu", "nu"), (params[:, cols],
                                                     mu[:, cols],
                                                     nu[:, cols]), want):
            if name == "step":
                g, r = ins[0] - g, ins[0] - r
            torch.testing.assert_close(g, r, **tol,
                                       msg=lambda m: f"{label}: {m}")
            worst = max(worst, (g - r).abs().max().item())
            share = max(share, tol_share(g, r, tol))
    return worst, share


def pop_adam_inplace_row(gen, n, p, label):
    """pop_adam at (N, P) with a per-member decay and clip scale, in
    place, as a vectorized LM step runs it: the first and last 2^24
    columns held to the plain version on copies of their inputs (the
    whole population has no room for an out-of-place result beside it),
    then timed by CUDA events beside its bound, the plain version over
    column chunks and ``torch._fused_adamw_``. Returns the row."""
    from repro_torch.kernels.pop_adam import pop_adam, pop_adam_plain

    def filled(draw):
        # a member's row at a time: pixtral's (2, 1.6 B) is past 2^31
        t = torch.empty((n, p), device="cuda")
        for row in t:
            draw(row)
        return t

    params, grads, mu = (filled(lambda r: r.normal_(generator=gen))
                         for _ in range(3))
    nu = filled(lambda r: r.uniform_(generator=gen))
    lr = torch.linspace(1e-4, 3e-3, n, device="cuda")
    step = torch.tensor([(1, 2, 1000)[i % 3] for i in range(n)],
                        dtype=torch.int32, device="cuda")
    extra = dict(wd=torch.linspace(0.0, 0.3, n, device="cuda"),
                 scale=torch.linspace(1.0, 0.25, n, device="cuda"))
    args = (params, grads, mu, nu, lr, step)
    chunk = 1 << 24
    worst, share = pop_adam_in_place_vs_plain(args, extra, ADAM_TOL, label)

    def plain_chunks():
        for c in range(0, p, chunk):
            cols = slice(c, min(p, c + chunk))
            pop_adam_plain(*(t[:, cols] for t in args[:4]), lr, step,
                           **extra)

    rows_of = lambda t: [t[i] for i in range(n)]
    steps_f = [torch.tensor(1.0, device="cuda") for _ in range(n)]

    def library():
        torch._fused_adamw_(rows_of(params), rows_of(grads), rows_of(mu),
                            rows_of(nu), [], steps_f, amsgrad=False,
                            lr=3e-4, beta1=0.9, beta2=0.999,
                            weight_decay=0.1, eps=1e-8, maximize=False,
                            grad_scale=None, found_inf=None)

    bound, bound_by = pop_adam_bound(n, p)
    row = {"net": label, "n": n, "p": p,
           "ms": events_ms(lambda: pop_adam(*args, **extra, inplace=True)),
           "plain_ms": events_ms(plain_chunks, reps=2),
           "library_ms": events_ms(library),
           "bound_ms": bound, "bound_by": bound_by,
           "max_abs_err": worst, "max_err_over_tolerance": share,
           "cache": f"cold ({28 * n * p / 1e9:.1f} GB a launch, past the "
                    f"50 MB L2)"}
    row["ms_over_bound"] = row["ms"] / bound
    log(f"pop_adam {label} (N={n}, P={p}, decay and clip scale, in "
        f"place): == plain on the first and last 2^24 columns (max abs err "
        f"{worst:.3g}, {share:.3g} of the tolerance); kernel "
        f"{row['ms']:.3f} ms, bound {bound:.3f} ms ({bound_by}; "
        f"{row['ms_over_bound']:.2f}x), plain {row['plain_ms']:.3f} ms (in "
        f"column chunks), _fused_adamw_ (one lr and decay) "
        f"{row['library_ms']:.3f} ms")
    del params, grads, mu, nu, args
    torch.cuda.empty_cache()
    return row


def phase_frontend_train():
    """Each frontend arch trained at full width through the port's entry
    point, ``python -m repro_torch.launch.train --arch A --num-layers L
    --population N --steps 4 --pbt-interval 2 --batch B --seq-len 512
    --ckpt-every 0`` (musicgen 2 layers, N = 4, B = 4; pixtral 1 layer,
    N = 2, B = 1, its first 256 positions zero patches with their labels
    masked; no checkpoint: pixtral's would write some 52 GB): the launch
    counts set to 0 just before and read just after (one pop_adam launch
    a step, no other kernel), an evolve at steps 2 and 4, finite losses
    (musicgen's exactly ln 2048: the CLI's zero frames make every logit
    0, as the JAX CLI's do), the members' parameter count from the config
    alone, the peak of allocated memory under 70 GB; then one more
    vectorized step timed (tokens/s per member) and profiled (busy share),
    and pop_adam at the run's (N, P) timed (``pop_adam_inplace_row``).
    Returns {arch: numbers}."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.pop_matmul import pop_matmul
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import lm
    from repro_torch.tree import flat_buffer

    counters = {"pop_adam": pop_adam, "flash_attention": flash_attention,
                "wkv6": wkv6, "ssd": ssd, "pop_matmul": pop_matmul}
    r = FRONTEND_TRAIN_RUN
    out = {}
    for arch, f in FRONTEND_TRAIN.items():
        t_arch = time.perf_counter()
        n, layers, b = f["population"], f["layers"], f["batch"]
        cfg = _lm_config(arch, num_layers=layers)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        with tempfile.TemporaryDirectory() as d:
            ckpt = Path(d) / "ck"
            argv = ["--arch", arch, "--num-layers", str(layers),
                    "--population", str(n), "--steps", str(r["steps"]),
                    "--pbt-interval", str(r["pbt_interval"]), "--batch",
                    str(b), "--seq-len", str(r["seq_len"]), "--ckpt-every",
                    "0", "--ckpt-dir", str(ckpt), "--seed", str(SEED)]
            reset_counts(*counters.values())
            t0 = time.perf_counter()
            report = train_main(argv)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            counts = {k: c.launches for k, c in counters.items()}
            if CheckpointManager(ckpt).latest() is not None:
                raise AssertionError(f"train {arch}: a checkpoint was "
                                     f"written under --ckpt-every 0")
        want = dict.fromkeys(counters, 0) | {"pop_adam": r["steps"]}
        if counts != want:
            raise AssertionError(f"train {arch}: launches {counts}, want "
                                 f"{want}")
        trainer = report.trainer
        p = flat_buffer(trainer.state.params).shape[1]
        if p != lm_param_count(cfg):
            raise AssertionError(f"train {arch}: {p} parameters a member, "
                                 f"the config gives {lm_param_count(cfg)}")
        evolved = [s for s, _ in report.evolutions]
        loss = report.metrics["loss"]
        if evolved != [2, 4] or not torch.isfinite(loss).all():
            raise AssertionError(f"train {arch}: evolutions "
                                 f"{report.evolutions}, losses "
                                 f"{loss.tolist()}")
        if cfg.frontend == "audio_frames":
            torch.testing.assert_close(
                loss, torch.full_like(loss, float(np.log(cfg.vocab_size))),
                rtol=1e-6, atol=0)
        tokens = torch.randint(0, cfg.vocab_size, (n * b, r["seq_len"]),
                               device="cuda")
        batch = {k: x.reshape((n, b) + x.shape[1:])
                 for k, x in lm.frontend_inputs(cfg, tokens).items()}

        def vec_step():
            trainer.state, _ = trainer.update(trainer.state, batch,
                                              trainer.hypers,
                                              trainer.generator)

        reset_counts(pop_adam)
        step_ms = _sync_ms(vec_step, reps=2)
        if pop_adam.launches != 3:
            raise AssertionError(f"train {arch}: {pop_adam.launches} "
                                 f"pop_adam launches in 3 vectorized steps")
        share, busy_ms, busy_wall_ms = device_busy_share(vec_step)
        peak = torch.cuda.max_memory_allocated()
        if peak >= LM_PEAK_LIMIT:
            raise AssertionError(f"train {arch}: peak allocated {peak:,} "
                                 f"bytes, limit {LM_PEAK_LIMIT:,.0f}")
        seq_tokens = b * r["seq_len"]
        row = {"layers": layers, "population": n,
               "parameters_per_member": p,
               "tokens_per_member_step": seq_tokens,
               "launches": counts, "evolutions": report.evolutions,
               "losses": loss.tolist(), "run_s": run_s,
               "vectorized_step_ms": step_ms,
               "tokens_per_s_per_member": seq_tokens / (step_ms / 1e3),
               "device_busy_share": share, "device_busy_ms": busy_ms,
               "busy_wall_ms": busy_wall_ms,
               "allocated_before_bytes": before,
               "max_memory_allocated_bytes": peak}
        log(f"train {arch} at full width, {layers} layers ({p:,} "
            f"parameters a member), N={n}, {b}x{r['seq_len']} tokens a "
            f"member and step, through the CLI: launches {counts}, "
            f"evolutions {report.evolutions}, losses "
            f"{[round(x, 4) for x in row['losses']]}, run {run_s:.1f} s; "
            f"a vectorized step {step_ms:.1f} ms "
            f"({row['tokens_per_s_per_member']:.0f} tokens/s per member), "
            f"device busy {busy_ms:.1f} of {busy_wall_ms:.1f} ms profiled "
            f"(share {'not measured' if share is None else f'{share:.4f}'})"
            f"; peak allocated {peak:,} bytes (before {before:,})")
        del report, trainer, batch, tokens
        gc.collect()
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
        row["pop_adam"] = pop_adam_inplace_row(gen, n, p, f"{arch} train")
        row["seconds"] = round(time.perf_counter() - t_arch, 1)
        log(f"train {arch} took {row['seconds']} s")
        out[arch] = row
    return out


def phase_lm_cem():
    """CEM over a language model's flat parameters. First the chunked
    in-place forms against the whole-matrix ones on the card: qwen2-0.5b
    at full width with 2 layers, N = 4, one fitness (with a tie) and one
    (N, P) draw: ``cem_update_chunked`` and ``cem_sample_into`` over
    ``LMAgent``'s buffer (column chunks of 2^24) equal ``cem_update`` and
    ``cem_sample`` over its ``ravel_stacked`` copy bit for bit, and the
    buffer stays where it was. Then qwen2-0.5b at full size through the
    CLI, ``--strategy cem --population 4 --steps 4 --pbt-interval 2
    --batch 4 --seq-len 512 --ckpt-every 0``, with the launch counts set
    to 0 just before and read just after (one pop_adam launch a step):
    the bind and two evolves each timed, the flat buffer's address
    unchanged across all three, lineage all -1, the distribution's (P,)
    float32 mean and variance, the noise decayed twice, and the peak of
    allocated memory under 70 GB. Returns the numbers."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core import cem
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.launch.train import main as train_main
    from repro_torch.pop import LMAgent
    from repro_torch.pop import strategy as strategy_mod
    from repro_torch.tree import flat_buffer

    t_phase = time.perf_counter()
    c = LM_CEM
    n = c["population"]
    # the chunked forms against the whole ones, 2 layers
    cfg = _lm_config(c["arch"], num_layers=LM_CEM_PARITY_LAYERS)
    agent = LMAgent(cfg, TrainConfig(), device="cuda")
    state = agent.population_init(torch.Generator().manual_seed(SEED), n)
    buffer = agent.evolvable_buffer(state)
    p = buffer.shape[1]
    fitness = torch.tensor([0.5, -1.0, 2.0, 0.5], device="cuda")[:n]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    eps = torch.randn(buffer.shape, generator=gen, device="cuda")
    centre = lambda: cem.cem_centre(buffer[0].clone())
    samples = cem.ravel_stacked(state.params)
    if not torch.equal(samples, buffer):
        raise AssertionError("LM CEM: the buffer is not the members' "
                             "ravel")
    whole = cem.cem_update(centre(), samples, fitness)
    drawn = cem.cem_sample(None, whole, n, eps=eps)
    del samples
    ptr = buffer.data_ptr()
    chunked = cem.cem_update_chunked(centre(), buffer, fitness)
    cem.cem_sample_into(buffer, None, chunked, eps=eps)
    torch.cuda.synchronize()
    same = {name: torch.equal(a, b) for name, a, b in (
        ("mean", chunked.mean, whole.mean), ("var", chunked.var, whole.var),
        ("noise", chunked.noise, whole.noise), ("redraw", buffer, drawn))}
    if not all(same.values()) or buffer.data_ptr() != ptr or \
            flat_buffer(state.params).data_ptr() != ptr:
        raise AssertionError(f"LM CEM: chunked == whole {same}, the buffer "
                             f"at {buffer.data_ptr():#x}, was {ptr:#x}")
    chunks = -(-p // cem.CHUNK)
    log(f"LM CEM {cfg.name} at full width, {LM_CEM_PARITY_LAYERS} layers "
        f"(N={n}, P={p:,}): the chunked refit and in-place redraw ({chunks} "
        f"chunks of {cem.CHUNK:,} columns) == the whole-matrix forms bit "
        f"for bit ({same}); the buffer stayed at its address")
    parity = {"parameters_per_member": p, "chunks": chunks, "equal": same}
    del agent, state, buffer, eps, whole, drawn, chunked
    gc.collect()
    torch.cuda.empty_cache()

    # the CLI at full size, the strategy's bind and evolves timed
    records = []
    real = {"bind": strategy_mod.CEM.bind, "evolve": strategy_mod.CEM.evolve}

    def timed(name):
        def call(self, generator, *a, **kw):
            agent = self._agent if name == "evolve" else a[0]
            pop_state = a[0] if name == "evolve" else a[1]
            before = agent.evolvable_buffer(pop_state).data_ptr()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = real[name](self, generator, *a, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            new_state = result[0] if name == "evolve" else result
            records.append({"call": name, "ms": ms, "before": before,
                            "after": agent.evolvable_buffer(
                                new_state).data_ptr()})
            return result
        return call

    argv = ["--arch", c["arch"], "--strategy", "cem", "--population",
            str(n), "--steps", str(c["steps"]), "--pbt-interval",
            str(c["pbt_interval"]), "--batch", str(c["batch"]), "--seq-len",
            str(c["seq_len"]), "--ckpt-every", "0", "--seed", str(SEED)]
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with mock.patch.object(strategy_mod.CEM, "bind", timed("bind")), \
            mock.patch.object(strategy_mod.CEM, "evolve", timed("evolve")), \
            tempfile.TemporaryDirectory() as d:
        reset_counts(pop_adam, flash_attention)
        t0 = time.perf_counter()
        report = train_main(argv + ["--ckpt-dir", str(Path(d) / "ck")])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    launches = {"pop_adam": pop_adam.launches,
                "flash_attention": flash_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    trainer = report.trainer
    st = trainer.strategy.cem_state
    p = flat_buffer(trainer.state.params).shape[1]
    addresses = {r["before"] for r in records} | {r["after"]
                                                  for r in records}
    problems = []
    if [r["call"] for r in records] != ["bind", "evolve", "evolve"]:
        problems.append(f"calls {[r['call'] for r in records]}")
    if len(addresses) != 1 or flat_buffer(
            trainer.state.params).data_ptr() not in addresses:
        problems.append(f"the buffer moved: {records}")
    if report.evolutions != [(2, [-1] * n), (4, [-1] * n)]:
        problems.append(f"evolutions {report.evolutions}")
    if launches != {"pop_adam": c["steps"], "flash_attention": 0}:
        problems.append(f"launches {launches}")
    if p != LM_PARAMS or st.mean.shape != (p,) or st.var.shape != (p,) or \
            st.mean.dtype != torch.float32 or st.var.dtype != torch.float32:
        problems.append(f"P {p}, mean {st.mean.shape} {st.mean.dtype}, var "
                        f"{st.var.shape} {st.var.dtype}")
    if abs(float(st.noise) - 1e-2 * 0.999 ** 2) > 1e-9:
        problems.append(f"noise {float(st.noise)}")
    if not np.isfinite(report.final_loss):
        problems.append(f"final loss {report.final_loss}")
    if peak >= LM_PEAK_LIMIT:
        problems.append(f"peak allocated {peak:,} bytes")
    if problems:
        raise AssertionError(f"LM CEM CLI: {'; '.join(problems)}")
    ms = {r["call"] + ("" if r["call"] == "bind" else f"_{i}"): r["ms"]
          for i, r in enumerate(records)}
    out = {"parity": parity, "arch": c["arch"], "population": n,
           "parameters_per_member": p, "launches": launches,
           "evolutions": report.evolutions,
           "final_loss": report.final_loss, "run_s": run_s,
           "strategy_ms": ms, "buffer_address_unchanged": True,
           "allocated_before_bytes": before,
           "max_memory_allocated_bytes": peak,
           "seconds": round(time.perf_counter() - t_phase, 1)}
    log(f"LM CEM {c['arch']} at full size through the CLI (N={n}, "
        f"P={p:,}, {c['batch']}x{c['seq_len']} tokens a member and step): "
        f"launches {launches}, evolutions {report.evolutions}, final loss "
        f"{report.final_loss:.4f}; bind and evolves "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items())
        + f", the flat buffer at one address throughout; mean and var "
        f"({p:,},) float32, noise {float(st.noise):.6g}; run {run_s:.1f} s, "
        f"peak allocated {peak:,} bytes (before {before:,}); "
        f"{out['seconds']} s")
    del report, trainer, st
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_acting_update_kernels():
    """pop_matmul and pop_adam at the acting engine's update batch (TD3 on
    hopper2d, obs 11, act 3, the repo's width, N = 8, B = 64): each
    forward shape of an update step against its plain version, then timed
    with its backwards beside their bounds, the plain version and
    ``baddbmm``+act (``training_rows``); the actor's and the twin critic's
    pop_adam beside ``torch._fused_adam_`` (``adam_row``). Returns the
    rows and their sums over one update step."""
    from repro_torch.kernels.pop_matmul import pop_matmul, pop_matmul_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    bsz = ACTING["batch"]
    shapes = (_shape_rows(HOPPER_ACTOR_LAYERS, 2, "actor")
              + _shape_rows(HOPPER_CRITIC_LAYERS, 6, "critic"))
    worst = share = 0.0
    for _, k, m, act, _, _ in shapes:
        x = torch.randn((POPULATION, bsz, k), generator=gen, device="cuda")
        w = torch.randn((POPULATION, k, m), generator=gen,
                        device="cuda") / k ** 0.5
        b = torch.randn((POPULATION, m), generator=gen, device="cuda")
        got = pop_matmul(x, w, b, activation=act)
        want = pop_matmul_plain(x, w, b, activation=act)
        torch.testing.assert_close(got, want, **TOL)
        worst = max(worst, (got - want).abs().max().item())
        share = max(share, tol_share(got, want, TOL))
    rows = training_rows(shapes, gen, label="hopper2d B=64 ", bsz=bsz)
    params = lambda layers: sum(k * m + m for k, m, _ in layers)
    adam = [adam_row(gen, "hopper2d actor", POPULATION,
                     params(HOPPER_ACTOR_LAYERS)),
            adam_row(gen, "hopper2d twin critic", POPULATION,
                     2 * params(HOPPER_CRITIC_LAYERS))]
    per_step = lambda key, rs: sum(r[key] * r.get(
        "launches_per_update_step", 1) for r in rs)
    out = {"work": f"one TD3 update step on hopper2d (N={POPULATION}, "
                   f"B={bsz}): 24 pop_matmul forwards, 12 backwards, 2 "
                   f"pop_adam launches; device times, CUDA graph replay, "
                   f"L2-warm",
           "max_abs_err": worst, "max_err_over_tolerance": share,
           "pop_matmul": {k: per_step(k, rows) for k in (
               "ms", "plain_ms", "bound_ms", "library_ms")},
           "pop_matmul_backward_ms": sum(r["backward_ms_per_step"]
                                         for r in rows),
           "pop_matmul_backward_bound_ms": sum(
               r["backward_bound_ms_per_step"] for r in rows),
           "pop_adam": {k: per_step(k, adam) for k in (
               "ms", "plain_ms", "bound_ms", "library_ms")},
           "pop_matmul_rows": rows, "pop_adam_rows": adam}
    log(f"the acting engine's update step (TD3 on hopper2d, N="
        f"{POPULATION}, B={bsz}): pop_matmul forwards == plain (max abs err "
        f"{worst:.3g}), 24 forwards {out['pop_matmul']['ms'] * 1e3:.3f} us "
        f"(bound {out['pop_matmul']['bound_ms'] * 1e3:.3f}, baddbmm "
        f"{out['pop_matmul']['library_ms'] * 1e3:.3f}), 12 backwards "
        f"{out['pop_matmul_backward_ms'] * 1e3:.3f} us (bound "
        f"{out['pop_matmul_backward_bound_ms'] * 1e3:.3f}); 2 pop_adam "
        f"{out['pop_adam']['ms'] * 1e3:.3f} us (bound "
        f"{out['pop_adam']['bound_ms'] * 1e3:.3f}, _fused_adam_ "
        f"{out['pop_adam']['library_ms'] * 1e3:.3f})")
    return out


# ------------------------- slice 15: checkpoint resume, run telemetry
def _state_trees(t):
    """A trainer's resumable trees: state, hypers, strategy state, the
    engine's buffers and env states, the generator's state."""
    return (t.state, t.hypers, t.strategy.export_state(),
            t.rollout.export_state(), t.generator.get_state())


def phase_resume_rl(ckpt_root):
    """Fused TD3 on hopper2d: 4 uninterrupted epochs against 2, a
    checkpoint, and 2 more in a fresh trainer resumed from it, bit for bit;
    a resume after the fresh trainer's capture refused. Then the eager TD3
    CLI on pendulum run twice on one --ckpt-dir against one run of twice
    the steps: the last checkpoints bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import main as train_main
    from repro_torch.tree import leaves

    f = FUSED
    epoch = f["pbt_interval"]
    t0 = time.perf_counter()
    whole = _fused_trainer("td3", "hopper2d", "pbt", num_envs=f["num_envs"])
    whole.run_env_loop(4 * epoch, eval_every=f["eval_every"], fused=True)
    first = _fused_trainer("td3", "hopper2d", "pbt", num_envs=f["num_envs"],
                           ckpt=Path(ckpt_root) / "fused")
    first.run_env_loop(2 * epoch, eval_every=f["eval_every"], fused=True)
    save_s = first.save(blocking=True)
    resumed = _fused_trainer("td3", "hopper2d", "pbt",
                             num_envs=f["num_envs"],
                             ckpt=Path(ckpt_root) / "fused")
    ptrs = [x.data_ptr() for x in leaves(_state_trees(resumed)[:2])]
    if resumed.resume() != 2 * epoch - 1:
        raise AssertionError("fused resume: not the step saved")
    if ptrs != [x.data_ptr() for x in leaves(_state_trees(resumed)[:2])]:
        raise AssertionError("fused resume rebound a tensor")
    resumed.run_env_loop(2 * epoch, eval_every=f["eval_every"], fused=True)
    torch.cuda.synchronize()
    same, err, _ = _tree_err(_state_trees(whole), _state_trees(resumed))
    if not same:
        raise AssertionError(f"fused resume != 4 uninterrupted epochs (max "
                             f"abs err {err})")
    try:
        resumed.resume()
    except RuntimeError as e:
        refused = str(e)
    else:
        raise AssertionError("a resume after a capture was not refused")
    launches = {k: a + b for (k, a), b in zip(
        _epoch_launches(first).items(), _epoch_launches(resumed).values())}
    expect_vec_route("resume fused", launches)
    nodes = [fn.node_count() for t in (whole, first, resumed)
             for fn in t._epochs.values()]
    fused_s = time.perf_counter() - t0
    log(f"resume fused TD3 hopper2d: 2 epochs, checkpoint ({save_s:.3f} s "
        f"blocking), a fresh trainer resumed for 2 more == 4 "
        f"uninterrupted epochs bit for bit (state, hypers, strategy, "
        f"buffers, env states, generator); leaves kept their storage; a "
        f"resume after the capture refused ({refused[:60]}...); launches "
        f"{launches}; graphs of {nodes} nodes; {fused_s:.1f} s")

    c = RESUME_CLI
    argv = ["--algo", "td3", "--env", "pendulum", "--population",
            str(POPULATION), "--pbt-interval", str(c["pbt_interval"]),
            "--eval-every", str(c["eval_every"]), "--num-envs",
            str(c["num_envs"]), "--collect-steps", str(c["collect_steps"]),
            "--updates-per-iter", str(c["updates"]), "--batch", str(BATCH),
            "--ckpt-every", str(c["steps"]), "--fused-adam",
            "--fused-linear", "--seed", str(SEED)]
    twice = str(Path(ckpt_root) / "twice")
    once = str(Path(ckpt_root) / "once")
    t0 = time.perf_counter()
    a, wall_a, mm_a, _, adam_a = _run_counted(lambda: train_main(
        argv + ["--steps", str(c["steps"]), "--ckpt-dir", twice]))
    b, wall_b, mm_b, _, adam_b = _run_counted(lambda: train_main(
        argv + ["--steps", str(c["steps"]), "--ckpt-dir", twice]))
    whole_run = train_main(argv + ["--steps", str(2 * c["steps"]),
                                   "--ckpt-dir", once])
    torch.cuda.synchronize()
    if b.trainer.step_count != 2 * c["steps"] or \
            CheckpointManager(twice).all_steps() != [c["steps"] - 1,
                                                     2 * c["steps"] - 1]:
        raise AssertionError(f"TD3 CLI twice: step {b.trainer.step_count}, "
                             f"checkpoints "
                             f"{CheckpointManager(twice).all_steps()}")
    same, err, _ = _tree_err(_state_trees(whole_run.trainer),
                             _state_trees(b.trainer))
    if not same:
        raise AssertionError(f"TD3 CLI run twice != once with twice the "
                             f"steps (max abs err {err})")
    last = f"step_{2 * c['steps'] - 1:010d}"
    for name in ("arrays", "aux_rollout", "aux_rng", "aux_hypers"):
        with np.load(Path(twice) / last / f"{name}.npz") as x, \
                np.load(Path(once) / last / f"{name}.npz") as y:
            if not all(np.array_equal(x[k], y[k]) for k in x.files):
                raise AssertionError(f"TD3 CLI: {name} differs")
    cli = {"pop_matmul": mm_a + mm_b, "pop_adam": adam_a + adam_b,
           "seconds": [wall_a, wall_b],
           "evolutions": [a.evolutions, b.evolutions]}
    log(f"resume TD3 CLI pendulum twice on one --ckpt-dir ({c['steps']} "
        f"iterations each, {wall_a:.2f} s and {wall_b:.2f} s): resumed at "
        f"step {c['steps']}, == one run of {2 * c['steps']} bit for bit "
        f"(trainers and the last checkpoint's main tree, rollout, rng, "
        f"hypers); launches pop_matmul {cli['pop_matmul']}, pop_adam "
        f"{cli['pop_adam']}; {time.perf_counter() - t0:.1f} s")
    reset_hopper2d_counts()
    return {"fused": {"bitwise": True, "launches": launches,
                      "graph_nodes": nodes,
                      "save_blocking_s": save_s, "seconds": fused_s,
                      "refused_after_capture": True},
            "cli": cli}


def phase_resume_lm(d):
    """qwen2-0.5b at full width, 2 layers, N = 2, through the train CLI:
    4 steps with --ckpt-every 2, and the same 4 steps resumed from the
    step-2 checkpoint; the resumed trainer's state against the
    uninterrupted one's. The async saves' blocked seconds from the ckpt
    rows of the run's log, a blocking save's from ``save``; the
    checkpoint's bytes. Works in the directory ``d`` and leaves the step-2
    checkpoint in ``d / "resumed"`` (the resumed run writes none) for the
    elastic phase; the rest is removed."""
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.launch.train import main as train_main

    r = LM_RESUME
    argv = ["--arch", r["arch"], "--num-layers", str(r["layers"]),
            "--population", str(r["population"]), "--steps",
            str(r["steps"]), "--pbt-interval", str(r["pbt_interval"]),
            "--batch", str(r["batch"]), "--seq-len", str(r["seq_len"]),
            "--ckpt-every", str(r["ckpt_every"]), "--seed", str(SEED)]
    t0 = time.perf_counter()
    reset_counts(pop_adam)
    whole = train_main(argv + ["--ckpt-dir", str(d / "whole"),
                               "--log-dir", str(d / "log")])
    torch.cuda.synchronize()
    whole_adam = pop_adam.launches
    t_whole = time.perf_counter() - t0
    rows = _log_rows(d / "log")
    ckpt_rows = [x for x in rows if x["kind"] == "ckpt"]
    if [x["step"] for x in ckpt_rows] != [1, 3]:
        raise AssertionError(f"LM resume log: ckpt rows {ckpt_rows}")
    # the step-2 checkpoint moves (a rename, not a 5 GB copy) into
    # the resumed run's directory; that run writes none of its own
    saved = d / "whole" / f"step_{1:010d}"
    ckpt_bytes = {p.name: p.stat().st_size for p in saved.iterdir()}
    (d / "resumed").mkdir()
    shutil.move(saved, d / "resumed" / saved.name)
    t0 = time.perf_counter()
    blocking_s = whole.trainer.save(blocking=True)
    reset_counts(pop_adam)
    resumed = train_main(argv[:-4] + [
        "--ckpt-every", "0", "--seed", str(SEED), "--ckpt-dir",
        str(d / "resumed"), "--resume", "auto"])
    torch.cuda.synchronize()
    resumed_adam = pop_adam.launches
    t_resumed = time.perf_counter() - t0 - blocking_s
    if resumed.trainer.step_count != r["steps"] or resumed_adam != \
            r["steps"] - 2 or whole_adam != r["steps"]:
        raise AssertionError(f"LM resume: step "
                             f"{resumed.trainer.step_count}, pop_adam "
                             f"{whole_adam} / {resumed_adam}")
    same, err, share = _tree_err(
        (whole.trainer.state, whole.trainer.hypers,
         whole.trainer.generator.get_state()),
        (resumed.trainer.state, resumed.trainer.hypers,
         resumed.trainer.generator.get_state()), tol=LM_RESUME_TOL)
    if share > 1.0:
        raise AssertionError(f"LM resume != uninterrupted (max abs err "
                             f"{err})")
    out = {"bitwise": same, "max_abs_err": err,
           "max_err_over_tolerance": share,
           "tolerance": "rtol=1e-4, atol=1e-6 (the LM update parity's)",
           "async_blocked_s": [x["secs"] for x in ckpt_rows],
           "blocking_s": blocking_s,
           "checkpoint_bytes": sum(ckpt_bytes.values()),
           "checkpoint_files": ckpt_bytes,
           "launches": {"pop_adam": whole_adam + resumed_adam},
           "seconds": {"uninterrupted": t_whole, "resumed": t_resumed},
           "final_loss": [whole.final_loss, resumed.final_loss]}
    del whole, resumed
    shutil.rmtree(d / "whole")
    log(f"resume LM {r['arch']} {r['layers']} layers N={r['population']} "
        f"through the CLI: steps 3-4 resumed from step 2's checkpoint == "
        f"uninterrupted ({'bit for bit' if same else f'max abs err {err:.3g}'}"
        f"); checkpoint {out['checkpoint_bytes'] / 1e9:.3f} GB; the loop "
        f"blocked {out['async_blocked_s']} s by async saves, "
        f"{blocking_s:.3f} s by a blocking one; {nvidia_smi_line()}")
    return out


def phase_telemetry_sink():
    """The acting engine's fused epoch (TD3 on hopper2d, ACTING's shape,
    no evolve) at each env count, with a strict JSONLSink attached from
    the trainer's construction: the epoch's capture runs with the step-0
    members row and the engine row in the sink, and a second epoch length
    is captured right after the first epoch's rows are written, while the
    writer copies them. Then SINK["rounds"] rounds each with the sink and
    with telemetry off, alternating, every replay under
    set_sync_debug_mode("error"); ms per iteration (median, with min and
    max), and every iter row's metrics and stats equal to what the loop
    returned."""
    from repro_torch.telemetry import JSONLSink, RunTelemetry, jsonable

    a = ACTING
    cfg = dict(population=a["population"], updates=a["updates"],
               pbt_interval=a["iters"], collect_steps=a["collect_steps"],
               eval_envs=1, eval_steps=1, batch=a["batch"])
    rows = {}
    launches = {"pop_matmul": 0, "pop_adam": 0, "hopper2d": 0,
                "hopper2d_vec": 0}
    for num_envs in a["envs"]:
        times = {"off": [], "sink": []}
        seen = []
        keep = lambda it, m, s, fit, lin: seen.append((m, s))
        with tempfile.TemporaryDirectory() as d:
            tel = RunTelemetry(JSONLSink(Path(d) / "t.jsonl", strict=True),
                               device="cuda")
            tr = _fused_trainer("td3", "hopper2d", "none",
                                num_envs=num_envs, cfg=cfg, telemetry=tel)
            # two captures with the sink live: the second while the
            # writer copies the first epoch's rows
            tr.run_env_loop(a["iters"], eval_every=0, fused=True,
                            on_iter=keep)
            tr.run_env_loop(a["iters"] // 2, eval_every=0, fused=True,
                            on_iter=keep)
            torch.cuda.synchronize()
            for r in range(SINK["rounds"]):
                for arm in (("off", "sink") if r % 2 else ("sink", "off")):
                    tr.telemetry = tel if arm == "sink" else RunTelemetry()
                    t0 = time.perf_counter()
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        tr.run_env_loop(
                            a["iters"], eval_every=0, fused=True,
                            on_iter=keep if arm == "sink" else None)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                    torch.cuda.synchronize()
                    times[arm].append((time.perf_counter() - t0) * 1e3
                                      / a["iters"])
            tr.telemetry = RunTelemetry()
            tel.close()          # strict: a row that failed raises here
            logged = [json.loads(x) for x in
                      (Path(d) / "t.jsonl").read_text().splitlines()]
        iters = [x for x in logged if x["kind"] == "iter"]
        captures = [x for x in logged if x["kind"] == "compile"
                    and x["event"] == "cuda_graph"]
        if len(iters) != len(seen) or len(tr._epochs) != 2 or \
                len(captures) != 2 or logged[0]["kind"] != "run" or \
                not any(x["kind"] == "members" and x["step"] == 0
                        for x in logged):
            raise AssertionError(f"sink {num_envs}: {len(iters)} iter rows "
                                 f"for {len(seen)} iterations, "
                                 f"{len(tr._epochs)} epochs captured, "
                                 f"{len(captures)} capture rows")
        for row, (m, s) in zip(iters, seen):
            host = lambda tree: None if tree is None else jsonable(
                {k: v.cpu() for k, v in tree.items()})
            if row.get("metrics") != host(m) or row["stats"] != host(s):
                raise AssertionError(f"sink {num_envs}: row {row['step']} "
                                     f"!= the loop's metrics")
        for k, v in _epoch_launches(tr).items():
            launches[k] += v
        cell = {}
        for arm, ts in times.items():
            ts = sorted(ts)
            cell[arm] = {"ms_per_iter": ts[len(ts) // 2], "min_ms": ts[0],
                         "max_ms": ts[-1]}
        cell["rows"] = len(logged)
        cell["graph_nodes"] = [fn.node_count() for fn in tr._epochs.values()]
        cell["captures_with_the_sink_live"] = [x["secs"] for x in captures]
        cell["sink_cost"] = (cell["sink"]["ms_per_iter"]
                             / cell["off"]["ms_per_iter"])
        rows[num_envs] = cell
        log(f"sink {num_envs} envs/member: fused epoch "
            f"{cell['off']['ms_per_iter']:.3f} ms per iteration without "
            f"telemetry, {cell['sink']['ms_per_iter']:.3f} with a strict "
            f"JSONL sink (x{cell['sink_cost']:.3f}; min/max "
            f"{cell['sink']['min_ms']:.3f}/{cell['sink']['max_ms']:.3f}); "
            f"2 captures with the sink live ({len(captures)} compile rows, "
            f"graphs of {cell['graph_nodes']} nodes), "
            f"every replay under sync debug 'error', {len(iters)} iter rows "
            f"== the loop's metrics and stats")
    expect_vec_route("sink", launches)
    reset_hopper2d_counts()
    return rows, launches


def _trace_kernels(trace_dir, names):
    """Count each kernel name's launches in the Chrome traces under
    ``trace_dir`` (events of category ``kernel``)."""
    counts = dict.fromkeys(names, 0)
    files = sorted(Path(trace_dir).glob("*.trace.json"))
    for path in files:
        for e in json.loads(path.read_text()).get("traceEvents", []):
            if e.get("cat") == "kernel":
                for n in names:
                    if n in e.get("name", ""):
                        counts[n] += 1
    return len(files), counts


def _log_rows(path):
    """The rows of a telemetry log, each checked against the row schema
    (the port's copy of the JAX package's, which ``tools/report.py
    --check`` applies; that tool imports the JAX package)."""
    from repro_torch.telemetry import validate_row

    rows = [json.loads(x) for x in
            (Path(path) / "telemetry.jsonl").read_text().splitlines()]
    bad = [e for e in map(validate_row, rows) if e]
    if bad:
        raise AssertionError(f"{path}: rows off the schema: {bad}")
    return rows


def phase_serve_telemetry_rl(ckpt_dir):
    """The RL serve CLI on a TD3 checkpoint without telemetry, then with
    --log-dir and --profile over SERVE_TELEMETRY["profile_iters"]
    batches: the rows schema-valid, serve and promotion rows present, the
    p50 beside the run without, and every pop_matmul launch of the window
    in the trace."""
    from repro_torch.kernels.pop_matmul import pop_matmul
    from repro_torch.launch.serve import main as serve_main

    argv = ["--algo", "td3", "--env", "pendulum", "--ckpt-dir", ckpt_dir,
            "--ensemble", str(ENSEMBLE), "--mode", "mean", "--fused-linear",
            "--batch", str(BATCH), "--requests", str(REQUESTS), "--seed",
            str(SEED)]
    iters = SERVE_TELEMETRY["profile_iters"]
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        plain = serve_main(argv)
        reset_counts(pop_matmul)
        served = serve_main(argv + ["--log-dir", str(d / "rl"),
                                    "--profile", str(d / "trace"),
                                    "--profile-iters", str(iters)])
        torch.cuda.synchronize()
        launches = pop_matmul.launches
        rows = _log_rows(d / "rl")
        serve_rows = [x for x in rows if x["kind"] == "serve"]
        files, kernels = _trace_kernels(d / "trace", ("pop_matmul",))
        profiled = 3 * iters            # 3 launches a served batch
        if not serve_rows or not any(x["kind"] == "promotion"
                                     for x in rows) or files != 1 or \
                kernels["pop_matmul"] != profiled:
            raise AssertionError(f"serve RL telemetry: {len(serve_rows)} "
                                 f"serve rows, traces {files}, kernels "
                                 f"{kernels} of {profiled} profiled")
    out = {"p50_ms": served.p50_ms, "p99_ms": served.p99_ms,
           "p50_ms_without": plain.p50_ms, "p99_ms_without": plain.p99_ms,
           "serve_rows": serve_rows, "rows": len(rows),
           "trace_kernel_launches": kernels, "profiled_launches": profiled,
           "process_age_s": time.perf_counter() - T_START,
           "launches": {"pop_matmul": launches}}
    log(f"serve RL with --log-dir and --profile: p50 {served.p50_ms:.4f} "
        f"ms, p99 {served.p99_ms:.4f} ms per batch of {BATCH} (without "
        f"telemetry p50 {plain.p50_ms:.4f}, p99 {plain.p99_ms:.4f}); "
        f"{len(rows)} rows schema-valid, serve windows p50 "
        f"{[x['p50_ms'] for x in serve_rows]}; the trace names "
        f"{kernels['pop_matmul']} of the window's {profiled} pop_matmul "
        f"launches ({out['process_age_s']:.0f} s into the process); "
        f"{nvidia_smi_line()}")
    return out


def phase_serve_telemetry_lm():
    """The LM serve CLI (qwen2-0.5b at full size, LM_SERVE's batch) with
    --log-dir and --profile: the rows schema-valid, and the trace holding
    every flash_attention launch the wrapper counted."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import main as serve_main

    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        reset_counts(flash_attention)
        lm = serve_main(["--arch", "qwen2-0.5b", "--batch",
                         str(LM_SERVE["batch"]), "--prompt-len",
                         str(LM_SERVE["prompt_len"]), "--tokens",
                         str(LM_SERVE["tokens"]), "--seed", str(SEED),
                         "--log-dir", str(d / "lm"), "--profile",
                         str(d / "trace")])
        torch.cuda.synchronize()
        launches = flash_attention.launches
        rows = _log_rows(d / "lm")
        files, kernels = _trace_kernels(d / "trace", ("flash_mma_bf16",))
        if rows[-1]["kind"] != "run_end" or files != 1 or launches != 24 \
                or kernels["flash_mma_bf16"] != launches:
            raise AssertionError(f"serve LM telemetry: traces {files}, "
                                 f"kernels {kernels}, launches {launches}")
    out = {"prefill_ms": lm.prefill_ms,
           "decode_ms_per_token": lm.decode_ms_per_token,
           "rows": len(rows), "trace_kernel_launches": kernels,
           "process_age_s": time.perf_counter() - T_START,
           "launches": {"flash_attention": launches}}
    log(f"serve LM qwen2-0.5b with --log-dir and --profile: prefill "
        f"{lm.prefill_ms:.2f} ms, {lm.decode_ms_per_token:.3f} ms per "
        f"decode step (profiled); {len(rows)} rows schema-valid; the trace "
        f"names {kernels['flash_mma_bf16']} flash_mma_bf16 launches of the "
        f"wrapper's {launches} ({out['process_age_s']:.0f} s into the "
        f"process)")
    return out


# ------------------------------- slice 16: elastic population resize
def _elastic_lineage(fitness, new_n):
    """The lineage an elastic resize must give, computed here from the
    fitness: a shrink keeps the new_n fittest in member order, a grow
    keeps every member and clones the fittest round-robin."""
    old = len(fitness)
    rank = sorted(range(old), key=lambda i: -fitness[i])
    if new_n <= old:
        return sorted(rank[:new_n])
    return list(range(old)) + [rank[i % old] for i in range(new_n - old)]


def _check_gathered(what, trainer, saved, lineage, old_n):
    """Every leaf of the trainer's state, hypers and engine state equal,
    bit for bit, to the saved one gathered by ``lineage`` (a leaf without
    the member axis equal as it was). Returns the leaves compared."""
    from repro_torch.tree import leaves

    idx = torch.tensor(lineage, device="cuda")
    got = leaves((trainer.state, trainer.hypers,
                  trainer.rollout.export_state()))
    if len(got) != len(saved):
        raise AssertionError(f"{what}: {len(got)} leaves, saved "
                             f"{len(saved)}")
    for i, (g, x) in enumerate(zip(got, saved)):
        want = x[idx] if x.ndim and x.shape[0] == old_n else x
        if not torch.equal(g, want):
            raise AssertionError(f"{what}: leaf {i} of shape "
                                 f"{tuple(g.shape)} is not the saved one "
                                 f"gathered by {lineage}")
    return len(got)


def _rl_elastic_trainer(n, ckpt):
    """TD3 on pendulum as the train CLI builds it for ELASTIC's runs."""
    from repro_torch.configs.base import PopulationConfig
    from repro_torch.envs import make
    from repro_torch.pop import PopTrainer
    from repro_torch.rl import get_algo, make_agent

    c = RESUME_CLI
    env = make("pendulum")
    pcfg = PopulationConfig(size=n, num_steps=c["updates"], pbt_interval=0,
                            hyper_space=get_algo("td3").hyper_space)
    tr = PopTrainer(make_agent("td3", env.spec, device="cuda"), pcfg,
                    seed=SEED, checkpoint_dir=ckpt)
    tr.attach_rollout(env, num_envs=c["num_envs"],
                      collect_steps=c["collect_steps"], batch_size=BATCH)
    return tr


def _printed_lineage(text, old_n, new_n):
    """The lineage the train CLI printed for its elastic resume."""
    found = re.findall(rf"elastic resume from step \d+: population "
                       rf"{old_n} -> {new_n}, lineage=\[([\d, ]*)\]", text)
    if len(found) != 1:
        raise AssertionError(f"the CLI printed no elastic resume "
                             f"{old_n} -> {new_n}: {text[-400:]}")
    return [int(x) for x in found[0].split(",")]


def _cli_printed(fn):
    """``fn()`` with its standard output captured and printed again:
    (result, text)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    text = buf.getvalue()
    print(text, end="")
    return out, text


def phase_elastic_rl(root):
    """TD3 on pendulum at N = 8 (B = 256), 2 iterations, saved with
    ELASTIC's fitness; for 6 and 12 members a fresh trainer restored by
    ``restore_elastic``: the lineage computed here from that fitness, every
    leaf of the state, hypers, replay rings with their counters and env
    states with their episode accounting gathered bit for bit into the
    trainer's own tensors, then 2 more iterations with their
    ``pop_matmul`` and ``pop_adam`` launches counted at the new N. The
    save, the restore and the first iteration after it timed (the phases
    of ``benchmarks/elastic_resize.py``). Then the train CLI with
    ``--resize auto`` at each size on a copy of the checkpoint (the
    lineage it prints, its launches), and ``--resize strict`` refused with
    a message that names ``--resize auto``."""
    from repro_torch.elastic import restore_elastic
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.pop_matmul import pop_matmul
    from repro_torch.launch.train import main as train_main
    from repro_torch.tree import leaves

    e, c = ELASTIC, RESUME_CLI
    old_n = e["population"]
    root = Path(root)
    src_dir = root / "src"
    t0 = time.perf_counter()
    src = _rl_elastic_trainer(old_n, src_dir)
    src.run_env_loop(e["iters"], eval_every=0)
    src.report_fitness(torch.tensor(e["fitness"], device="cuda"))
    torch.cuda.synchronize()
    save_s = src.save(blocking=True)
    saved = [x.clone() for x in leaves((src.state, src.hypers,
                                        src.rollout.export_state()))]
    del src
    ckpt_bytes = sum(p.stat().st_size for p in src_dir.rglob("*")
                     if p.is_file())
    per_iter = {"pop_matmul": 24 * c["updates"] + 3 * c["collect_steps"],
                "pop_adam": 2 * c["updates"]}
    out = {"save_s": save_s, "checkpoint_bytes": ckpt_bytes, "restored": {},
           "cli": {}, "launches": {"pop_matmul": 0, "pop_adam": 0}}
    for n in e["sizes"]:
        want = _elastic_lineage(e["fitness"], n)
        tr = _rl_elastic_trainer(n, src_dir)
        ptrs = [x.data_ptr() for x in leaves((tr.state, tr.hypers))]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step, lineage = restore_elastic(tr)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        if step != e["iters"] - 1 or lineage.tolist() != want or ptrs != [
                x.data_ptr() for x in leaves((tr.state, tr.hypers))]:
            raise AssertionError(f"elastic RL {old_n} -> {n}: step {step}, "
                                 f"lineage {lineage.tolist()} (want "
                                 f"{want}), a tensor rebound")
        compared = _check_gathered(f"elastic RL {old_n} -> {n}", tr, saved,
                                   want, old_n)
        reset_counts(pop_matmul, pop_adam)
        t1 = time.perf_counter()
        tr.run_env_loop(1, eval_every=0)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t1
        tr.run_env_loop(e["iters"] - 1, eval_every=0)
        torch.cuda.synchronize()
        launches = {"pop_matmul": pop_matmul.launches,
                    "pop_adam": pop_adam.launches}
        if launches != {k: v * e["iters"] for k, v in per_iter.items()} \
                or not all(torch.isfinite(x).all() for x in leaves(tr.state)
                           if x.is_floating_point()):
            raise AssertionError(f"elastic RL {old_n} -> {n}: launches "
                                 f"{launches} (want {per_iter} an "
                                 f"iteration), or a parameter not finite")
        for k, v in launches.items():
            out["launches"][k] += v
        out["restored"][n] = {"lineage": want, "restore_s": restore_s,
                              "first_iter_s": first_s,
                              "leaves_compared": compared,
                              "launches": launches}
        log(f"elastic RL TD3 pendulum {old_n} -> {n}: lineage {want} (from "
            f"the fitness); {compared} leaves (state, hypers, replay rings "
            f"and counters, env states and episode accounting) gathered bit "
            f"for bit into the trainer's own tensors; save {save_s:.3f} s "
            f"(blocking), restore {restore_s:.3f} s, first iteration after "
            f"it {first_s:.3f} s; {e['iters']} iterations at N={n}: "
            f"launches {launches}")
        del tr

    argv = ["--algo", "td3", "--env", "pendulum", "--pbt-interval", "0",
            "--eval-every", str(e["iters"]), "--num-envs",
            str(c["num_envs"]), "--collect-steps", str(c["collect_steps"]),
            "--updates-per-iter", str(c["updates"]), "--batch", str(BATCH),
            "--steps", str(e["iters"]), "--fused-adam", "--fused-linear",
            "--seed", str(SEED)]
    want_cli = {"pop_matmul": per_iter["pop_matmul"] * e["iters"]
                + 3 * EVAL_STEPS, "pop_adam": per_iter["pop_adam"]
                * e["iters"]}
    for n in e["sizes"]:
        d = root / f"cli_{n}"
        shutil.copytree(src_dir, d)
        (report, wall, mm, _, adam), text = _cli_printed(
            lambda: _run_counted(lambda: train_main(
                argv + ["--population", str(n), "--resize", "auto",
                        "--ckpt-dir", str(d)])))
        printed = _printed_lineage(text, old_n, n)
        launches = {"pop_matmul": mm, "pop_adam": adam}
        if printed != _elastic_lineage(e["fitness"], n) or \
                launches != want_cli or \
                report.trainer.step_count != 2 * e["iters"]:
            raise AssertionError(f"elastic RL CLI {old_n} -> {n}: lineage "
                                 f"{printed}, launches {launches} (want "
                                 f"{want_cli}), step "
                                 f"{report.trainer.step_count}")
        out["cli"][n] = {"lineage": printed, "seconds": wall,
                         "launches": launches}
        log(f"elastic RL CLI --population {n} --resize auto: printed "
            f"lineage {printed}, {e['iters']} iterations in {wall:.2f} s, "
            f"launches {launches}")
    d = root / "strict"
    shutil.copytree(src_dir, d)
    try:
        train_main(argv + ["--population", str(e["sizes"][0]), "--resize",
                           "strict", "--ckpt-dir", str(d)])
    except ValueError as err:
        refused = str(err)
    else:
        refused = ""
    if "--resize auto" not in refused:
        raise AssertionError(f"--resize strict at another size: "
                             f"{refused!r}")
    out["strict_refused"] = refused
    out["seconds"] = time.perf_counter() - t0
    log(f"elastic RL CLI --resize strict at {e['sizes'][0]} members "
        f"refused: {refused}; phase {out['seconds']:.1f} s; "
        f"{nvidia_smi_line()}")
    return out


def phase_elastic_fused(root):
    """The acting engine's fused TD3 on hopper2d (FUSED's shape, N = 8),
    2 epochs, saved with ELASTIC's fitness; for 6 and 12 members two
    trainers restored by ``restore_elastic``, one running 2 fused epochs
    (captured after the restore at the new N, the second a replay under
    ``set_sync_debug_mode("error")``), the other the eager loop: equal
    bit for bit (state, hypers, buffers, env states, strategy, last
    fitness, lineage). Launches: the graph's captured launches times its
    replays plus its warm-up's, and the eager loop's counts."""
    from repro_torch.elastic import restore_elastic
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.pop_matmul import pop_matmul

    f, e = FUSED, ELASTIC
    epoch, old_n = f["pbt_interval"], f["population"]
    d = Path(root) / "fused"
    t0 = time.perf_counter()
    first = _fused_trainer("td3", "hopper2d", "pbt", num_envs=f["num_envs"],
                           ckpt=d)
    first.run_env_loop(2 * epoch, eval_every=f["eval_every"], fused=True)
    first.report_fitness(torch.tensor(e["fitness"], device="cuda"))
    save_s = first.save(blocking=True)
    launches = _epoch_launches(first)
    del first
    out = {"save_s": save_s, "restored": {}}
    for n in e["sizes"]:
        want = _elastic_lineage(e["fitness"], n)
        runs = {}
        for kind in ("fused", "eager"):
            tr = _fused_trainer("td3", "hopper2d", "pbt",
                                num_envs=f["num_envs"],
                                cfg=dict(f, population=n), ckpt=d)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step, lineage = restore_elastic(tr)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t1
            if step != 2 * epoch - 1 or lineage.tolist() != want:
                raise AssertionError(f"elastic fused {old_n} -> {n}: step "
                                     f"{step}, lineage {lineage.tolist()} "
                                     f"(want {want})")
            reset_counts(pop_matmul, pop_adam)
            reset_hopper2d_counts()
            lin, secs = [], []
            for i in range(2):
                t1 = time.perf_counter()
                if kind == "fused" and i:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    tr.run_env_loop(
                        epoch, eval_every=f["eval_every"],
                        fused=kind == "fused",
                        on_iter=lambda it, m, s, fit, l: l is not None
                        and lin.append(l))
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t1)
            counted = ({"pop_matmul": pop_matmul.launches,
                        "pop_adam": pop_adam.launches, **hopper2d_counts()}
                       if kind == "eager" else _epoch_launches(tr))
            runs[kind] = (tr, lin, {"restore_s": restore_s,
                                    "epoch_s": secs, "launches": counted})
        (fused, lin_f, row_f), (eager, lin_e, row_e) = (runs["fused"],
                                                        runs["eager"])
        checks = {
            "state": _tree_err(eager.state, fused.state),
            "hypers": _tree_err(eager.hypers, fused.hypers),
            "buffers": _tree_err(eager.rollout.bufs, fused.rollout.bufs),
            "env_states": _tree_err(eager.rollout.vstate,
                                    fused.rollout.vstate),
            "strategy": _tree_err(eager.strategy.export_state(),
                                  fused.strategy.export_state()),
            "last_fitness": _tree_err(eager.last_fitness,
                                      fused.last_fitness),
            "lineage": _tree_err(lin_e, lin_f)}
        (fn,) = fused._epochs.values()
        bitwise = all(c[0] for c in checks.values())
        for kind, row in (("fused", row_f), ("eager", row_e)):
            expect_vec_route(f"elastic {kind} {old_n} -> {n}",
                             row["launches"])
        if not bitwise or len(lin_f) != 2 or fn.replays != 2:
            raise AssertionError(f"elastic fused {old_n} -> {n}: captured "
                                 f"vs eager {checks}, {len(lin_f)} evolves, "
                                 f"{fn.replays} replays, launches "
                                 f"{row_f['launches']}")
        for k, v in row_f["launches"].items():
            launches[k] += v + row_e["launches"][k]
        out["restored"][n] = {"lineage": want, "bitwise": True,
                              "graph_nodes": fn.node_count(),
                              "capture_s": fn.capture_seconds,
                              "fused": row_f, "eager": row_e}
        log(f"elastic fused TD3 hopper2d {old_n} -> {n}: lineage {want}; "
            f"2 epochs captured after the restore == the eager loop bit for "
            f"bit (state, hypers, buffers, env states, strategy, fitness, "
            f"lineage); save {save_s:.3f} s, restore "
            f"{row_f['restore_s']:.3f} s, epochs {row_f['epoch_s']} s fused "
            f"(the first with warm-up and a capture of "
            f"{fn.node_count()} nodes), {row_e['epoch_s']} s eager; "
            f"launches fused {row_f['launches']}, eager "
            f"{row_e['launches']}")
        del runs, fused, eager
    reset_hopper2d_counts()
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    return out


def _npz_arrays(path):
    """The arrays of an uncompressed ``.npz`` (``np.savez``'s), each a
    read-only memory map of its bytes in the file: read from the page
    cache as they are used, without the zip reader's checksum pass (about
    0.5 GB/s, half a minute for an LM checkpoint's main tree)."""
    import struct
    import zipfile

    with zipfile.ZipFile(path) as z:
        infos = z.infolist()
    out = {}
    with open(path, "rb") as f:
        for info in infos:
            if info.compress_type != zipfile.ZIP_STORED:
                raise AssertionError(f"{path}: {info.filename} compressed")
            f.seek(info.header_offset)
            header = f.read(30)
            name_len, extra_len = struct.unpack("<HH", header[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            out[info.filename[:-len(".npy")]] = np.memmap(
                path, dtype=dtype, mode="r", shape=shape, offset=f.tell(),
                order="F" if fortran else "C")
    return out


def phase_elastic_lm(ckpt):
    """qwen2-0.5b at full width, 2 layers: phase 40's step-2 checkpoint (N
    = 2) resumed at 1 and at 3 members through the train CLI with
    ``--resize auto`` and ``--steps`` at the checkpoint's (so the CLI
    restores and returns): the lineage it prints, the host seconds of
    ``restore_elastic`` and the peak of allocated memory; every row of
    every leaf bit for bit against the checkpoint's, the flat (N, P)
    buffers kept (the leaves their views); one ``pop_adam`` step on the
    restored buffers held against its plain version at LM_RESUME_TOL;
    then one step of the resumed trainer (one ``pop_adam`` launch at the
    new N, in place, a finite loss). ``--resize strict`` refused."""
    import repro_torch.elastic as elastic
    from repro_torch.data import host_batches
    from repro_torch.elastic import plan_resize
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.launch.train import main as train_main
    from repro_torch.tree import flat_buffer, leaves

    r = LM_RESUME
    ckpt = Path(ckpt)
    start = r["ckpt_every"]          # the step after the checkpoint's
    step_dir = ckpt / f"step_{start - 1:010d}"
    meta = json.loads((step_dir / "meta.json").read_text())["extra"]
    saved = _npz_arrays(step_dir / "arrays.npz")
    argv = ["--arch", r["arch"], "--num-layers", str(r["layers"]),
            "--steps", str(start), "--pbt-interval", str(r["pbt_interval"]),
            "--batch", str(r["batch"]), "--seq-len", str(r["seq_len"]),
            "--ckpt-every", "0", "--seed", str(SEED), "--ckpt-dir",
            str(ckpt)]
    old_n = meta["size"]
    t0 = time.perf_counter()
    out = {"checkpoint_fitness": meta["fitness"], "restored": {}}
    real = elastic.restore_elastic
    timed = {}

    def timed_restore(trainer, *args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        result = real(trainer, *args, **kwargs)
        torch.cuda.synchronize()
        timed.update(gather_s=time.perf_counter() - t1,
                     allocated_before=before,
                     peak_bytes=torch.cuda.max_memory_allocated())
        return result

    for n in LM_ELASTIC_SIZES:
        want = plan_resize(old_n, n, meta["fitness"])[1].tolist()
        gc.collect()
        torch.cuda.empty_cache()
        with mock.patch.object(elastic, "restore_elastic", timed_restore):
            report, text = _cli_printed(lambda: train_main(
                argv + ["--population", str(n), "--resize", "auto"]))
        trainer = report.trainer
        flats = (trainer.state.params, trainer.state.opt_state.mu,
                 trainer.state.opt_state.nu)
        printed = _printed_lineage(text, old_n, n)
        if printed != want or trainer.step_count != start:
            raise AssertionError(f"elastic LM {old_n} -> {n}: lineage "
                                 f"{printed} (want {want}), step "
                                 f"{trainer.step_count}")
        t1 = time.perf_counter()
        rows = 0
        mine = leaves((trainer.state, trainer.strategy.export_state()))
        if len(saved) != len(mine):
            raise AssertionError(f"elastic LM: {len(saved)} leaves saved, "
                                 f"{len(mine)} restored")
        for i, leaf in enumerate(mine):
            x = saved[f"leaf_{i}"]
            if not (x.ndim and x.shape[0] == old_n):
                raise AssertionError(f"elastic LM: leaf {i} has no member "
                                     f"axis")
            for j, p in enumerate(want):
                if not torch.equal(leaf[j], torch.as_tensor(
                        np.asarray(x[p]), device="cuda")):
                    raise AssertionError(f"elastic LM {old_n} -> {n}: leaf "
                                         f"{i} row {j} is not saved row "
                                         f"{p}")
                rows += 1
        check_s = time.perf_counter() - t1
        # the leaves are still views of one flat (N, P) buffer each, which
        # the population step writes in place
        params, mu, nu = (flat_buffer(t) for t in flats)
        ptrs = [params.data_ptr(), mu.data_ptr(), nu.data_ptr()]
        # one pop_adam step on the restored buffers against its plain
        # version
        p_cols = params.shape[1]
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        grads = torch.empty_like(params)
        for row in grads:
            row.normal_(generator=gen)
        lr = torch.full((n,), 3e-4, device="cuda")
        worst, share = pop_adam_in_place_vs_plain(
            (params, grads, mu, nu, lr, trainer.state.opt_state.step + 1),
            {}, LM_RESUME_TOL, f"elastic LM {old_n} -> {n}")
        del grads
        # the resumed trainer trains on: the CLI's stream at its next step
        stream = host_batches(trainer.agent.cfg.vocab_size, r["batch"] * n,
                              r["seq_len"], seed=SEED, start_step=start)
        batch = {"tokens": torch.from_numpy(next(stream)).to("cuda").reshape(
            n, r["batch"], r["seq_len"])}
        reset_counts(pop_adam)
        metrics, _ = trainer.step(batch)
        torch.cuda.synchronize()
        loss = metrics["loss"].mean().item()
        if pop_adam.launches != 1 or not np.isfinite(loss) or ptrs != [
                flat_buffer(t).data_ptr() for t in flats]:
            raise AssertionError(f"elastic LM {old_n} -> {n}: pop_adam "
                                 f"{pop_adam.launches}, loss {loss}, or a "
                                 f"flat buffer replaced")
        out["restored"][n] = {
            "lineage": want, "gather_s": timed["gather_s"],
            "allocated_before_bytes": timed["allocated_before"],
            "peak_bytes": timed["peak_bytes"], "rows_compared": rows,
            "check_s": check_s, "pop_adam_max_abs_err": worst,
            "pop_adam_max_err_over_tolerance": share,
            "parameters_per_member": p_cols, "loss_after": loss,
            "launches": {"pop_adam": pop_adam.launches}}
        log(f"elastic LM {r['arch']} {r['layers']} layers {old_n} -> {n} "
            f"through the CLI: lineage {want} (checkpoint fitness "
            f"{meta['fitness']}); restore_elastic {timed['gather_s']:.3f} s "
            f"on the host, allocated {timed['allocated_before'] / 1e9:.2f} "
            f"GB before it (the new trainer) and at most "
            f"{timed['peak_bytes'] / 1e9:.2f} GB during it; {rows} rows "
            f"bit for bit, the flat buffers kept; pop_adam "
            f"at ({n}, {p_cols}) on them == plain (max abs err "
            f"{worst:.3g}, {share:.3g} of rtol=1e-4, atol=1e-6); one more "
            f"step: 1 pop_adam launch in place, loss {loss:.4f}")
        del report, trainer, flats, params, mu, nu, metrics, mine, leaf
    del saved
    gc.collect()
    torch.cuda.empty_cache()
    try:
        train_main(argv + ["--population", str(LM_ELASTIC_SIZES[0])])
    except ValueError as err:
        refused = str(err)
    else:
        refused = ""
    if "--resize auto" not in refused:
        raise AssertionError(f"LM --resize strict at another size: "
                             f"{refused!r}")
    out["launches"] = {"pop_adam": sum(x["launches"]["pop_adam"]
                                       for x in out["restored"].values())}
    out["seconds"] = time.perf_counter() - t0
    log(f"elastic LM --resize strict at {LM_ELASTIC_SIZES[0]} members "
        f"refused: {refused}; phase {out['seconds']:.1f} s; "
        f"{nvidia_smi_line()}")
    return out


def phase_double_buffer():
    """DoubleBuffer on the card: DOUBLE_BUFFER's batches (the LM train
    phase's tokens and a float leaf) through it and used on the current
    stream under ``set_sync_debug_mode("error")``: no host
    synchronisation, and each batch equal to its host values."""
    from repro_torch.configs import get_config
    from repro_torch.data import DoubleBuffer, host_batches

    b = DOUBLE_BUFFER
    cfg = get_config(LM_TRAIN["arch"])
    stream = host_batches(cfg.vocab_size, LM_TRAIN["population"]
                          * LM_TRAIN["batch"], LM_TRAIN["seq_len"],
                          seed=SEED)
    rng = np.random.default_rng(SEED)
    host = [{"tokens": next(stream),
             "embeds": rng.standard_normal(b["floats"], dtype=np.float32)}
            for _ in range(b["batches"])]
    got, sums = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for batch in DoubleBuffer(iter(host), device="cuda"):
            got.append(batch)
            sums.append(batch["embeds"].sum() + batch["tokens"].sum())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if len(got) != len(host):
        raise AssertionError(f"DoubleBuffer: {len(got)} batches of "
                             f"{len(host)}")
    for i, (g, h) in enumerate(zip(got, host)):
        if not all(x.device.type == "cuda" and
                   np.array_equal(x.cpu().numpy(), h[k])
                   for k, x in g.items()):
            raise AssertionError(f"DoubleBuffer: batch {i} != its host "
                                 f"values")
    nbytes = sum(x.nbytes for h in host for x in h.values())
    log(f"DoubleBuffer: {len(host)} batches ({nbytes / 1e6:.2f} MB: tokens "
        f"{host[0]['tokens'].shape}, floats {b['floats']}) to the card "
        f"under sync debug 'error' in {secs * 1e3:.2f} ms, each equal to "
        f"its host values")
    return {"batches": len(host), "bytes": nbytes, "seconds": secs}


def accounting_line(lm_train):
    """The LM train phase's model FLOPs a step (6 x active parameters x
    tokens, ``models.accounting``) and their share of the card's dense
    bf16 peak (its matmuls run in the config's bf16) at that phase's
    vectorized step time."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.models.accounting import active_param_count, model_flops

    cfg = get_config(lm_train["arch"])
    if cfg.dtype != "bfloat16":
        raise AssertionError(f"{cfg.name} computes in {cfg.dtype}")
    n = LM_TRAIN["population"]
    shape = ShapeSpec("lm_train_step", LM_TRAIN["seq_len"],
                      n * LM_TRAIN["batch"], "train")
    flops = model_flops(cfg, shape)
    step_ms = lm_train["vectorized_step_ms"]
    rate = flops / (step_ms / 1e3)
    out = {"arch": cfg.name, "active_parameters": active_param_count(cfg),
           "tokens_per_step": shape.seq_len * shape.global_batch,
           "model_flops_per_step": flops, "step_ms": step_ms,
           "model_flops_per_s": rate, "peak_flops": PEAK_BF16_FLOPS,
           "peak_dtype": "bf16", "share_of_peak": rate / PEAK_BF16_FLOPS,
           "card": nvidia_smi_line()}
    log(f"accounting: {cfg.name} LM train step (N={n}, "
        f"{out['tokens_per_step']} tokens) is {flops:.4g} model FLOPs "
        f"(6 x {out['active_parameters']} active parameters x tokens); at "
        f"{step_ms:.1f} ms a step {rate / 1e12:.2f} TFLOP/s, "
        f"{out['share_of_peak']:.4f} of the dense bf16 peak (989 TFLOP/s "
        f"at 700 W); card {out['card']}")
    return out


def phase_examples():
    """``repro_torch.examples.quickstart`` and ``.pbt_td3`` on the card,
    their ``pop_matmul`` and ``pop_adam`` launches counted against what
    their loops make."""
    from repro_torch.examples import pbt_td3, quickstart
    from repro_torch.tree import leaves

    x = EXAMPLES
    q_iters = x["quickstart_iters"]
    tr, q_s, q_mm, _, q_adam = _run_counted(
        lambda: quickstart.run(iters=q_iters, device="cuda"))
    # an iteration: STEPS acting steps of 3 launches, one update step
    want_q = {"pop_matmul": q_iters * (3 * quickstart.STEPS + 24),
              "pop_adam": 2 * q_iters}
    n, p_iters = x["pbt_td3_population"], x["pbt_td3_iters"]
    best, p_s, p_mm, _, p_adam = _run_counted(
        lambda: pbt_td3.run(population=n, iters=p_iters, device="cuda"))
    # pbt_td3's shape: 32 acting steps and 64 updates an iteration (4
    # envs fill its batch of 128 in the first), an evaluation every 2
    want_p = {"pop_matmul": p_iters * (24 * 64 + 3 * 32)
              + 3 * EVAL_STEPS * (p_iters // 2),
              "pop_adam": p_iters * 2 * 64}
    got_q = {"pop_matmul": q_mm, "pop_adam": q_adam}
    got_p = {"pop_matmul": p_mm, "pop_adam": p_adam}
    finite = all(torch.isfinite(v).all() for v in leaves(tr.state)
                 if v.is_floating_point())
    if got_q != want_q or got_p != want_p or not np.isfinite(best) or \
            not finite:
        raise AssertionError(f"examples: quickstart {got_q} (want "
                             f"{want_q}), pbt_td3 {got_p} (want {want_p}), "
                             f"best fitness {best}, finite {finite}")
    log(f"examples: quickstart {q_iters} iterations in {q_s:.2f} s, "
        f"launches {got_q}; pbt_td3 N={n} {p_iters} iterations in "
        f"{p_s:.2f} s, best fitness {best:+.2f}, launches {got_p}")
    return {"quickstart": {"seconds": q_s, "launches": got_q},
            "pbt_td3": {"seconds": p_s, "best_fitness": best,
                        "launches": got_p},
            "launches": {k: got_q[k] + got_p[k] for k in got_q}}


# ------------------------------------------- slice 18: islands over ranks
def _islands_pcfg(n, space=None):
    from repro_torch.configs.base import PopulationConfig
    from repro_torch.rl import get_algo
    return PopulationConfig(
        size=n, strategy="pbt", backend="islands",
        num_steps=ISLANDS["updates"], pbt_interval=0,
        hyper_space=space or get_algo("td3").hyper_space)


def _islands_trainer(n, ckpt):
    """TD3 on hopper2d at the repo's width through the islands backend
    (ISLANDS' shape), no evolve on its own: the phases evolve it."""
    from repro_torch.envs import make
    from repro_torch.pop import PopTrainer
    from repro_torch.rl import make_agent

    env = make("hopper2d")
    c = ISLANDS
    tr = PopTrainer(make_agent("td3", env.spec, device="cuda"),
                    _islands_pcfg(n), seed=SEED, checkpoint_dir=ckpt)
    tr.attach_rollout(env, num_envs=c["num_envs"],
                      collect_steps=c["collect_steps"],
                      batch_size=c["batch"])
    return tr


def _cpu_leaves(tree):
    from repro_torch.tree import leaves
    return [x.detach().cpu() for x in leaves(tree)]


def _island_counts():
    """The launch counts the islands phases read: pop_matmul by route,
    pop_adam, hopper2d and its vec route."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.pop_matmul import pop_matmul
    counts = launch_counts()
    return {"pop_matmul": counts["pop_matmul"],
            "pop_matmul_by_route": dict(pop_matmul.launches_by_route),
            "pop_adam": counts["pop_adam"], "hopper2d": counts["hopper2d"],
            "hopper2d_vec": counts["hopper2d_vec"]}


def _reset_island_counts():
    from repro_torch.kernels.hopper2d import hopper2d_step
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.pop_matmul import pop_matmul
    reset_counts(pop_matmul, pop_adam, hopper2d_step)


def _td3_islands(rank, world, job):
    """ISLANDS' TD3 run on this rank (or alone, world 1): 2 iterations, an
    evolve on ISLANDS_FITNESS (its parents on rank 0, its children on rank
    1), 1 iteration with an evaluation, a blocking checkpoint. Returns the
    rows, the state before and after the evolve, the final state and
    engine state, the lineage, the exchange's seconds and bytes, the
    iterations' ms and the launch counts of the run."""
    tr = _islands_trainer(ISLANDS["population"], job["ckpt"])
    _reset_island_counts()
    iter_ms = []

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        iter_ms.append((time.perf_counter() - t0) * 1e3)

    for _ in range(2):
        timed(tr.env_iteration)
    pre = _cpu_leaves(tr.state)
    tr.report_fitness(torch.tensor(ISLANDS_FITNESS, device="cuda"))
    lineage = tr.evolve().tolist()
    post = _cpu_leaves(tr.state)
    exchange = dict(getattr(tr.strategy.gather, "last", {}))
    timed(lambda: tr.run_env_loop(1, eval_every=1))
    counts = _island_counts()
    tr.save(blocking=True)
    return {"rows": tuple(tr.rows), "islands": tr.layout.islands,
            "pre": pre, "post": post, "lineage": lineage,
            "final": _cpu_leaves(tr.state),
            "rollout": _cpu_leaves(tr.rollout.export_state()),
            "hypers": _cpu_leaves(tr.hypers), "exchange": exchange,
            "iter_ms": iter_ms, "counts": counts}


def _elastic_grow_rank(rank, world, job):
    """The checkpoint of ISLANDS' 8 members restored at job["n"] members
    on this rank's island: the lineage, this rank's rows against the
    saved ones gathered by it, bit for bit, and one more iteration."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.elastic import restore_elastic
    from repro_torch.tree import leaves

    tr = _islands_trainer(job["n"], job["ckpt"])
    mgr = CheckpointManager(job["ckpt"])
    old_n = ISLANDS["population"]
    (state, _), extra = mgr.restore((tr.state,
                                     tr.strategy.export_state()))
    saved = {"state": state, "hypers": mgr.restore_aux("hypers", tr.hypers),
             "rollout": mgr.restore_aux("rollout",
                                        tr.rollout.export_state())}
    t0 = time.perf_counter()
    step, lineage = restore_elastic(tr)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    rows = tr.rows
    mine = lineage[rows.lo:rows.hi]
    compared = 0
    for name, tree, full in (("state", tr.state, False),
                             ("hypers", tr.hypers, True),
                             ("rollout", tr.rollout.export_state(), False)):
        take = lineage if full else mine
        for got, x in zip(leaves(tree), leaves(saved[name])):
            x = torch.from_numpy(np.asarray(x))
            want = x[torch.as_tensor(take)] if x.ndim and \
                x.shape[0] == old_n else x
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"elastic {old_n} -> {job['n']} on "
                                     f"rank {rank}: a {name} leaf of shape "
                                     f"{tuple(got.shape)} is not the saved "
                                     f"one gathered by the lineage")
            compared += 1
    _reset_island_counts()
    _, _, did = tr.env_iteration()
    torch.cuda.synchronize()
    return {"rows": tuple(rows), "step": step, "lineage": lineage.tolist(),
            "fitness": extra.get("fitness"), "leaves": compared,
            "restore_s": restore_s, "did_update": did,
            "counts": _island_counts()}


def _dp_rank(rank, world, job):
    """``make_dp_update`` on the card over this gloo group, on the JAX
    test's problem (a linear fit, Adam at lr 0.05; tests/
    test_dp_compression.py), plain and int8: the parameters, the wire bytes
    each rank puts on the wire per reduction, and the ms of one reduction
    of a DP["grad_elems"]-element gradient by each."""
    from repro_torch.optim import adam
    from repro_torch.optim.dp import (compressed_psum_tree, make_dp_update,
                                      plain_psum_tree, wire_bytes)
    target = torch.arange(8.0, device="cuda") / 4 - 1.0
    rng = np.random.default_rng(SEED)
    batches = torch.from_numpy(rng.standard_normal(
        (DP["steps"], 8 * world, 8)).astype(np.float32)).cuda()

    def grad_fn(params, batch):
        w = params["w"].detach().requires_grad_(True)
        loss = torch.mean((batch @ w - batch @ target) ** 2)
        (g,) = torch.autograd.grad(loss, w)
        return loss.detach(), {"w": g}

    out = {}
    for compression in ("none", "int8"):
        params = {"w": torch.zeros(8, device="cuda")}
        opt_init, opt_update = adam(lr=0.05)
        opt_state = opt_init(params)
        error = {"w": torch.zeros(8, device="cuda")}
        update = make_dp_update(grad_fn, opt_update, compression=compression)
        for i in range(DP["steps"]):
            params, opt_state, error, loss = update(
                params, opt_state, error, batches[i, 8 * rank:8 * (rank + 1)])
        out[compression] = params["w"].cpu()
        out[compression + "_loss"] = float(loss)
    grads = {"g": torch.randn(DP["grad_elems"], device="cuda",
                              generator=torch.Generator("cuda").manual_seed(
                                  rank))}
    zeros = {"g": torch.zeros_like(grads["g"])}
    out["reduction_ms"] = {
        "none": _sync_ms(lambda: plain_psum_tree(grads), reps=5),
        "int8": _sync_ms(lambda: compressed_psum_tree(grads, zeros), reps=5)}
    out["wire_bytes"] = {c: wire_bytes(grads, world, c)
                         for c in ("none", "int8")}
    out["problem_wire_bytes"] = {c: wire_bytes(params, world, c)
                                 for c in ("none", "int8")}
    return out


def _session_rank(rank, world, store, out, jobs_file):
    """One gloo rank of a session on cuda:0: joins the group through a
    FileStore and runs each job of ``jobs_file`` in turn (the name of a
    module-level function of this script and its arguments); writes the
    results, or the traceback, beside ``out``."""
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.launch.mesh import leave_distributed
    torch.cuda.set_device(0)
    try:
        jobs = torch.load(jobs_file, weights_only=False)
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=600))
        results = {}
        for name, fn, job in jobs:
            results[name] = globals()[fn](rank, world, job)
            dist.barrier()
        leave_distributed()
        torch.save(results, out)
    except BaseException:
        Path(out + ".err").write_text(traceback.format_exc())
        raise SystemExit(1)


# what the ranks' fork server imports once: a rank forked from it starts
# with torch (and what its first collective and Triton launch import)
# already imported, where a rank spawned afresh paid for their import in
# every session; it imports this script anew, which is quick once torch
# is in. None of them touches the card.
SESSION_PRELOAD = ("torch", "torch._dynamo", "torch.distributed", "numpy",
                   "repro_torch.pop", "repro_torch.rl", "repro_torch.elastic",
                   "repro_torch.launch.train", "repro_torch.launch.serve")


def _start_fork_server():
    """Start the session ranks' fork server now, so that its imports
    (SESSION_PRELOAD) run beside the kernels' build; it and the resource
    tracker it uses are stopped when the script exits."""
    import atexit
    import multiprocessing as mp
    from multiprocessing import forkserver
    mp.get_context("forkserver").set_forkserver_preload(list(SESSION_PRELOAD))
    forkserver.ensure_running()
    atexit.register(_stop_fork_server)


def _stop_fork_server():
    """Stop the fork server and then the resource tracker, each waited
    for: no process of the script outlives it."""
    from multiprocessing import forkserver, resource_tracker
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def _spawn_session(jobs, world, tmp, timeout):
    """``jobs`` on ``world`` gloo ranks sharing cuda:0, forked by the fork
    server (:func:`_start_fork_server`) that holds SESSION_PRELOAD
    imported and never touched the card; each rank's
    results, in rank order. The jobs reach the ranks in a file, not
    through the fork server's pipe, which passes at most a few hundred
    descriptors (a tensor shared through it takes one). A rank that raises
    fails the phase with its traceback; ranks alive at ``timeout`` are
    killed."""
    import multiprocessing as mp
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(list(SESSION_PRELOAD))
    store = str(Path(tmp) / "store")
    jobs_file = str(Path(tmp) / "jobs.pt")
    torch.save(jobs, jobs_file)
    outs = [str(Path(tmp) / f"rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=_session_rank,
                         args=(r, world, store, outs[r], jobs_file))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.perf_counter()))
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [Path(o + ".err").read_text() for o in outs
              if Path(o + ".err").exists()]
    if errors or alive or any(p.exitcode for p in procs):
        raise AssertionError(f"islands ranks failed (alive after {timeout} "
                             f"s: {alive}; exit codes "
                             f"{[p.exitcode for p in procs]}):\n"
                             + "\n".join(errors))
    return [torch.load(o, weights_only=False) for o in outs]


def _npz_leaves(path):
    with np.load(path) as data:
        return [data[f"leaf_{i}"] for i in range(len(data.files))]


def phase_islands_cli(root):
    """48. The train CLI through ``torch.distributed.run --nproc-per-node
    1`` (a world of one NCCL rank): TD3 on hopper2d at the repo's width,
    N = 8, 256 envs a member, one evolve, ``--backend islands`` and
    ``sharded``, each against the same command with ``--backend
    vectorized`` (plain ``python``), the three side by side on the card
    (each its own process): exit 0, the layout printed as one
    island over an NCCL group, and every leaf of the last checkpoint
    equal, bit for bit where no arithmetic happens and at the update
    tolerance otherwise (counted). Returns the runs' seconds and
    counts."""
    c = ISLANDS_CLI
    argv = ["--algo", "td3", "--env", "hopper2d", "--population",
            str(ISLANDS["population"]), "--fused-adam", "--fused-linear",
            "--num-envs", str(ISLANDS["num_envs"]), "--collect-steps",
            str(ISLANDS["collect_steps"]), "--updates-per-iter",
            str(ISLANDS["updates"]), "--batch", str(ISLANDS["batch"]),
            "--steps", str(c["steps"]), "--pbt-interval",
            str(c["pbt_interval"]), "--eval-every", "1", "--seed",
            str(SEED)]
    env = dict(__import__("os").environ, PYTHONPATH=str(SRC))
    out = {}
    # the three runs side by side on the card, each its own process
    runs = {}
    for backend in ("vectorized", "islands", "sharded"):
        launch = [sys.executable] if backend == "vectorized" else [
            sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "1"]
        runs[backend] = (time.perf_counter(), subprocess.Popen(
            launch + ["-m", "repro_torch.launch.train", *argv, "--backend",
                      backend, "--ckpt-dir", str(Path(root) / backend)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    for backend, (t0, proc) in runs.items():
        try:
            stdout, stderr = proc.communicate(timeout=c["timeout"])
        except subprocess.TimeoutExpired:
            for _, p in runs.values():
                p.kill()
            raise
        secs = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"islands CLI --backend {backend} exited "
                                 f"{proc.returncode}:\n{stdout[-2000:]}\n"
                                 f"{stderr[-3000:]}")
        if backend != "vectorized" and (
                "1 island, rank 0 holds members 0..7" not in stdout
                or "process group nccl over 1 rank" not in stdout):
            raise AssertionError(f"islands CLI --backend {backend}: no "
                                 f"one-island NCCL layout printed:\n"
                                 f"{stdout[-1500:]}")
        evolves = re.findall(r"evolve at iter \d+: lineage=(\[[\d, ]*\])",
                             stdout)
        if len(evolves) != 1:
            raise AssertionError(f"islands CLI --backend {backend}: "
                                 f"{len(evolves)} evolves printed, want 1")
        out[backend] = {"seconds": secs, "lineage": json.loads(evolves[0])}
    want_dir = Path(root) / "vectorized"
    (step,) = sorted(p.name for p in want_dir.iterdir())
    for backend in ("islands", "sharded"):
        exact = close = 0
        for f in sorted((want_dir / step).glob("*.npz")):
            got = _npz_leaves(Path(root) / backend / step / f.name)
            want = _npz_leaves(f)
            if len(got) != len(want):
                raise AssertionError(f"islands CLI {backend}: {f.name} "
                                     f"holds {len(got)} leaves, want "
                                     f"{len(want)}")
            for g, w in zip(got, want):
                if np.array_equal(g, w):
                    exact += 1
                    continue
                np.testing.assert_allclose(
                    g, w, **STEP1_GRAD_TOL,
                    err_msg=f"islands CLI {backend}: {f.name}")
                close += 1
        out[backend].update(leaves_bit_for_bit=exact, leaves_close=close)
        if out[backend]["lineage"] != out["vectorized"]["lineage"]:
            raise AssertionError(f"islands CLI {backend}: lineage "
                                 f"{out[backend]['lineage']}, vectorized "
                                 f"{out['vectorized']['lineage']}")
        log(f"islands CLI --backend {backend} (torch.distributed.run, one "
            f"NCCL rank; the three runs side by side on the card): "
            f"{out[backend]['seconds']:.1f} s, checkpoint "
            f"{exact} leaves bit for bit and {close} within rtol 1e-4, atol "
            f"1e-6 of --backend vectorized "
            f"({out['vectorized']['seconds']:.1f} s)")
    return out


def phase_islands_ranks(root):
    """49, 50 and 52. Two gloo ranks sharing cuda:0 (spawned) run
    ISLANDS' TD3 (``_td3_islands``: 3 iterations and an evolve whose
    parents are on rank 0 and children on rank 1), then restore its
    checkpoint at 12 members over both ranks, then the DP reduction;
    against the same TD3 run on one rank in this process. Held: each
    rank's launch counts (pop_matmul by route, pop_adam, hopper2d on its
    vec route) equal to the one-rank run's, since a launch takes all the
    members a rank holds; the lineage equal; the exchange bit for bit
    (every member's row after the evolve is its parent's before it); the
    state and engine state at the update tolerance of the one-rank run's
    (bit for bit counted); the checkpoint rank 0 wrote equal, bit for bit,
    to the ranks' rows. Then 50: that checkpoint restored at 6 members in
    this process and at 12 over the two ranks, every rank's rows the saved
    ones gathered by the lineage (from the checkpoint's fitness), and one
    more iteration each; 52: ``make_dp_update`` plain and int8 (the JAX
    test's tolerance, 0.1, and convergence, 0.05) and the wire bytes.
    Prints ms per iteration with one rank and with two on the one card,
    which share it: no speed-up is claimed."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.elastic import restore_elastic

    n = ISLANDS["population"]
    one_dir = Path(root) / "one"
    two_dir = Path(root) / "two"
    gc.collect()
    torch.cuda.empty_cache()
    one = _td3_islands(0, 1, {"ckpt": str(one_dir)})
    t0 = time.perf_counter()
    ranks = _spawn_session(
        [("td3", "_td3_islands", {"ckpt": str(two_dir)}),
         ("grow", "_elastic_grow_rank", {"ckpt": str(two_dir),
                                          "n": ELASTIC["sizes"][1]}),
         ("dp", "_dp_rank", {})],
        2, root, ISLANDS["timeout"])
    session_s = time.perf_counter() - t0
    out = {"session_s": session_s}

    # 49: launches, lineage, exchange, update, checkpoint
    two = [r["td3"] for r in ranks]
    for r, res in enumerate(two):
        if res["counts"] != one["counts"]:
            raise AssertionError(f"islands rank {r}: launches "
                                 f"{res['counts']}, one rank's "
                                 f"{one['counts']}")
        if res["lineage"] != one["lineage"]:
            raise AssertionError(f"islands rank {r}: lineage "
                                 f"{res['lineage']}, one rank's "
                                 f"{one['lineage']}")
    lineage = one["lineage"]
    crossing = [i for i, p in enumerate(lineage) if p // 4 != i // 4]
    if not crossing:
        raise AssertionError(f"islands: the evolve's lineage {lineage} "
                             f"crosses no rank")
    pre = [torch.cat([res["pre"][i] for res in two]) for i in
           range(len(two[0]["pre"]))]
    idx = torch.tensor(lineage)
    for res in two:
        lo, hi, _ = res["rows"]
        for i, (post, full) in enumerate(zip(res["post"], pre)):
            if not torch.equal(post, full[idx[lo:hi]]):
                raise AssertionError(f"islands exchange: leaf {i} of rows "
                                     f"{lo}..{hi - 1} is not the parents' "
                                     f"rows before the evolve")
    exact = close = 0
    worst = 0.0
    for res in two:
        lo, hi, _ = res["rows"]
        for got, want in zip(res["final"] + res["rollout"],
                             one["final"] + one["rollout"]):
            want = want[lo:hi]
            if torch.equal(got, want):
                exact += 1
                continue
            worst = max(worst, tol_share(got.double(), want.double(),
                                         STEP1_GRAD_TOL))
            close += 1
    if worst > 1:
        raise AssertionError(f"islands: two ranks' state {worst:.3g} of "
                             f"rtol 1e-4, atol 1e-6 from one rank's")
    (step,) = sorted(p.name for p in two_dir.iterdir())
    saved = _npz_leaves(two_dir / step / "arrays.npz")
    rows = [torch.cat([res["final"][i] for res in two]) for i in
            range(len(two[0]["final"]))]
    saved_roll = _npz_leaves(two_dir / step / "aux_rollout.npz")
    roll = [torch.cat([res["rollout"][i] for res in two]) for i in
            range(len(two[0]["rollout"]))]
    if len(saved) != len(rows) or not all(
            np.array_equal(s, r.numpy()) for s, r in
            zip(saved + saved_roll, rows + roll)):
        raise AssertionError("islands: the checkpoint rank 0 wrote is not "
                             "the ranks' rows, bit for bit")
    ms_one = one["iter_ms"]
    ms_two = [max(res["iter_ms"][k] for res in two)
              for k in range(len(ms_one))]
    ex = two[1]["exchange"]
    out["td3"] = {
        "launches_per_rank": two[0]["counts"],
        "launches_by_rank": [res["counts"] for res in two],
        "launches_one_rank": one["counts"], "lineage": lineage,
        "crossing_members": crossing,
        "exchange": {r: res["exchange"] for r, res in enumerate(two)},
        "state_leaves_bit_for_bit": exact, "state_leaves_close": close,
        "state_worst_share": worst, "iter_ms_one_rank": ms_one,
        "iter_ms_two_ranks_one_card": ms_two,
        "checkpoint_leaves": len(saved) + len(saved_roll)}
    log(f"islands, 2 gloo ranks sharing cuda:0, TD3 hopper2d N={n} x "
        f"{ISLANDS['num_envs']} envs: launches per rank {two[0]['counts']} "
        f"= one rank's; lineage {lineage} (members {crossing} take a parent "
        f"from the other rank); exchange {ex['members']} member rows, "
        f"{ex['bytes']:,} bytes in {ex['seconds'] * 1e3:.2f} ms (gloo via "
        f"the host); state {exact} leaves bit for bit, {close} within rtol "
        f"1e-4, atol 1e-6 (worst {worst:.3g}); checkpoint = the ranks' rows "
        f"bit for bit; ms per iteration one rank "
        f"{[round(x, 2) for x in ms_one]}, two ranks on one card "
        f"{[round(x, 2) for x in ms_two]} (one card shared: no speed-up "
        f"claimed)")

    # 50: elastic across world sizes, 8 on 2 ranks -> 6 on 1, 12 on 2
    fitness = CheckpointManager(two_dir).peek_extra()["fitness"]
    elastic = {}
    for new_n in ELASTIC["sizes"]:
        want = _elastic_lineage(fitness, new_n)
        if new_n == ELASTIC["sizes"][1]:
            grown = [r["grow"] for r in ranks]
            for r, res in enumerate(grown):
                if res["lineage"] != want or not res["did_update"]:
                    raise AssertionError(f"elastic 8 -> {new_n} rank {r}: "
                                         f"lineage {res['lineage']}, want "
                                         f"{want}; updated "
                                         f"{res['did_update']}")
            elastic[new_n] = {"world": 2, "lineage": want,
                              "leaves_bit_for_bit": sum(
                                  res["leaves"] for res in grown),
                              "restore_s": max(res["restore_s"]
                                               for res in grown),
                              "counts": grown[0]["counts"]}
            continue
        tr = _islands_trainer(new_n, str(Path(root) / "six"))
        t0 = time.perf_counter()
        _, got = restore_elastic(tr, directory=two_dir)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        saved_all = [torch.from_numpy(x).cuda() for x in (
            saved + _npz_leaves(two_dir / step / "aux_hypers.npz")
            + saved_roll)]
        compared = _check_gathered(f"elastic 8 -> {new_n} on one rank", tr,
                                   saved_all, want, n)
        if got.tolist() != want:
            raise AssertionError(f"elastic 8 -> {new_n}: lineage "
                                 f"{got.tolist()}, want {want}")
        _, _, did = tr.env_iteration()
        if not did:
            raise AssertionError(f"elastic 8 -> {new_n}: no update after "
                                 f"the restore")
        elastic[new_n] = {"world": 1, "lineage": want,
                          "leaves_bit_for_bit": compared,
                          "restore_s": restore_s}
        del tr
    out["elastic"] = elastic
    log(f"islands elastic: 8 members saved on 2 ranks, restored at 6 on "
        f"one rank (lineage {elastic[6]['lineage']}, {elastic[6]['leaves_bit_for_bit']} "
        f"leaves bit for bit, {elastic[6]['restore_s']:.2f} s) and at 12 on "
        f"two (lineage {elastic[12]['lineage']}, "
        f"{elastic[12]['leaves_bit_for_bit']} leaves bit for bit over both "
        f"ranks, {elastic[12]['restore_s']:.2f} s); training went on")

    # 52: the DP reduction
    dp = [r["dp"] for r in ranks]
    target = np.arange(8.0, dtype=np.float32) / 4 - 1.0
    for c in ("none", "int8"):
        if not torch.equal(dp[0][c], dp[1][c]):
            raise AssertionError(f"DP {c}: the ranks' parameters differ")
        err = float(np.abs(dp[0][c].numpy() - target).max())
        if err > DP["converge_atol"]:
            raise AssertionError(f"DP {c}: {err:.3g} from the target after "
                                 f"{DP['steps']} steps")
    gap = float((dp[0]["int8"] - dp[0]["none"]).abs().max())
    if gap > DP["plain_atol"]:
        raise AssertionError(f"DP: int8 {gap:.3g} from plain, beyond "
                             f"{DP['plain_atol']}")
    out["dp"] = {"steps": DP["steps"], "int8_vs_plain_max_abs": gap,
                 "wire_bytes": dp[0]["wire_bytes"],
                 "grad_elems": DP["grad_elems"],
                 "problem_wire_bytes": dp[0]["problem_wire_bytes"],
                 "reduction_ms": {r: d["reduction_ms"]
                                  for r, d in enumerate(dp)}}
    log(f"DP reduction, 2 gloo ranks on cuda:0: int8 {gap:.3g} from plain "
        f"after {DP['steps']} steps (tolerance {DP['plain_atol']}), both "
        f"within {DP['converge_atol']} of the target; wire bytes a rank for "
        f"{DP['grad_elems']:,} fp32 gradients: plain "
        f"{dp[0]['wire_bytes']['none']:,}, int8 "
        f"{dp[0]['wire_bytes']['int8']:,}; ms a reduction (gloo via the "
        f"host) {dp[0]['reduction_ms']}")
    return out


def _digest(t, chunk: int = 1 << 24):
    """A bit-level digest of a tensor on the card: the sum of its 32-bit
    words and their sum weighted by position (mod 65521), taken ``chunk``
    words at a time (int64 sums wrap alike in any grouping), so that its
    temporaries stay small beside a population's buffer."""
    words = t.contiguous().view(torch.int32).reshape(-1)
    total = weighted = 0
    for c in range(0, words.numel(), chunk):
        v = words[c:c + chunk].to(torch.int64)
        w = (torch.arange(c, c + v.numel(), device=v.device) % 65521) + 1
        total += int(v.sum())
        weighted += int((v * w).sum())
    wrap = lambda x: (x + 2 ** 63) % 2 ** 64 - 2 ** 63
    return (wrap(total), wrap(weighted))


def _lm_islands_rank(rank, world, job):
    """qwen2-0.5b at full width, 2 layers, float32, N = 4 over this rank's
    island: 2 steps (the first at lr 0 under warmup), then an evolve on
    fitness [4, 3, 2, 1] whose child (member 3) is on the last rank and
    parent (member 0) on the first. Then, on this rank alone, the same 2
    steps of the 4 members on one rank (the vectorized backend, no
    group), and this rank's rows held to it by the LM update rule (the
    parameters after step 1 bit for bit; the gradients from Adam's first
    moment at rtol 1e-4, atol 1e-6; the step p - p' of step 2 on the
    elements whose reference gradients exceed 1e-6 in both steps). The
    exchanged rows are digested before and after the evolve."""
    from repro_torch.configs import HyperSpace, TrainConfig
    from repro_torch.configs.base import PopulationConfig
    from repro_torch.data.lm_pipeline import host_batches
    from repro_torch.pop import LMAgent, PopTrainer
    from repro_torch.tree import flat_buffer, leaves

    c = LM_ISLANDS
    cfg = _lm_config(c["arch"], num_layers=c["layers"], dtype="float32")
    tcfg = TrainConfig(total_steps=2, warmup_steps=1)
    n = c["population"]
    stream = host_batches(cfg.vocab_size, n * c["batch"], c["seq_len"],
                          seed=SEED)
    batches = [{"tokens": torch.from_numpy(next(stream)).reshape(
        n, c["batch"], c["seq_len"]).cuda()} for _ in range(2)]
    space = HyperSpace(**LM_HYPER_SPACE)

    def trainer(backend):
        pcfg = PopulationConfig(size=n, strategy="pbt", backend=backend,
                                pbt_interval=0, hyper_space=space)
        return PopTrainer(LMAgent(cfg, tcfg, device="cuda"), pcfg,
                          seed=SEED)

    def bufs(state):
        return (flat_buffer(state.params), flat_buffer(state.opt_state.mu),
                flat_buffer(state.opt_state.nu))

    def two_steps(tr, rows):
        sl = slice(rows[0], rows[1])
        tr.step(batches[0])
        mu1 = bufs(tr.state)[1][sl].clone()
        p1 = bufs(tr.state)[0][sl].clone()
        tr.step(batches[1])
        return p1, mu1, bufs(tr.state)[0][sl].clone(), \
            bufs(tr.state)[1][sl].clone()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = trainer("islands")
    rows = tr.rows
    local = (0, rows.count)
    p1, mu1, p2, mu2 = two_steps(tr, local)
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    parent, child = 0, n - 1
    sent = [_digest(b[parent - rows.lo]) for b in bufs(tr.state)] \
        if rows.lo <= parent < rows.hi else None
    tr.report_fitness(torch.tensor([4.0, 3.0, 2.0, 1.0], device="cuda"))
    lineage = tr.evolve().tolist()
    got = [_digest(b[child - rows.lo]) for b in bufs(tr.state)] \
        if rows.lo <= child < rows.hi else None
    exchange = dict(tr.strategy.gather.last)
    peak = torch.cuda.max_memory_allocated()
    views = all(x._base is flat_buffer(tr.state.params)
                for x in leaves(tr.state.params))
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    ref = trainer("vectorized")
    q1, nu1, q2, nu2 = two_steps(ref, (rows.lo, rows.hi))
    del ref
    if not torch.equal(p1, q1):
        raise AssertionError(f"LM islands rank {rank}: the parameters after "
                             f"step 1 (lr 0) moved apart")
    g_isl = (mu1 / 0.1, (mu2 - 0.9 * mu1) / 0.1)
    g_ref = (nu1 / 0.1, (nu2 - 0.9 * nu1) / 0.1)
    grad_share = max(tol_share(a, b, STEP1_GRAD_TOL)
                     for a, b in zip(g_isl, g_ref))
    keep = ((g_ref[0].abs() > LM_STEP_GRAD_FLOOR)
            & (g_ref[1].abs() > LM_STEP_GRAD_FLOOR))
    step_share = tol_share((p1 - p2)[keep], (q1 - q2)[keep], STEP1_GRAD_TOL)
    exact = bool(torch.equal(p2, q2))
    return {"rows": tuple(rows), "lineage": lineage, "sent": sent,
            "got": got, "exchange": exchange, "peak_bytes": peak,
            "steps_s": steps_s, "views_kept": views,
            "grad_share": grad_share, "step_share": step_share,
            "step_elements_held": int(keep.sum()),
            "elements": keep.numel(), "bit_for_bit": exact}


def phase_islands_lm(root):
    """51. LM islands: ``_lm_islands_rank`` on two gloo ranks sharing
    cuda:0. Held: the lineage copies member 0 (rank 0) into member 3
    (rank 1); the rows rank 1 received equal, bit for bit (digests), the
    rows rank 0 sent; the flat buffers kept as the leaves' base; each
    rank's rows within the LM update rule of the one-rank run. Prints the
    exchange's seconds and bytes and each rank's peak of allocated
    memory."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = [r["lm"] for r in _spawn_session(
        [("lm", "_lm_islands_rank", {})], 2, root, LM_ISLANDS["timeout"])]
    seconds = time.perf_counter() - t0
    want = [0, 1, 2, 0]
    for r, res in enumerate(ranks):
        if res["lineage"] != want:
            raise AssertionError(f"LM islands rank {r}: lineage "
                                 f"{res['lineage']}, want {want}")
        if not res["views_kept"]:
            raise AssertionError(f"LM islands rank {r}: the parameters are "
                                 f"no longer views of the flat buffer")
        for what in ("grad_share", "step_share"):
            if res[what] > 1:
                raise AssertionError(f"LM islands rank {r}: {what} "
                                     f"{res[what]:.3g} of rtol 1e-4, atol "
                                     f"1e-6 from the one-rank run")
    if ranks[0]["sent"] != ranks[1]["got"] or ranks[0]["sent"] is None:
        raise AssertionError("LM islands: member 3's rows after the evolve "
                             "are not member 0's before it")
    ex = ranks[1]["exchange"]
    out = {"arch": LM_ISLANDS["arch"], "layers": LM_ISLANDS["layers"],
           "population": LM_ISLANDS["population"], "seconds": seconds,
           "lineage": want, "exchange": ex,
           "peak_bytes_per_rank": [r["peak_bytes"] for r in ranks],
           "grad_share": [r["grad_share"] for r in ranks],
           "step_share": [r["step_share"] for r in ranks],
           "bit_for_bit": [r["bit_for_bit"] for r in ranks],
           "steps_s": [r["steps_s"] for r in ranks]}
    log(f"LM islands, {LM_ISLANDS['arch']} full width {LM_ISLANDS['layers']}"
        f" layers fp32, N={LM_ISLANDS['population']} over 2 gloo ranks on "
        f"cuda:0: lineage {want}, member 0's rows (rank 0) in member 3's "
        f"slot (rank 1) bit for bit: {ex['bytes']:,} bytes in "
        f"{ex['seconds']:.2f} s (gloo via the host); peak allocated per "
        f"rank {[round(r['peak_bytes'] / 2**30, 2) for r in ranks]} GiB; "
        f"vs one rank: gradients {out['grad_share']}, step "
        f"{out['step_share']} of rtol 1e-4, atol 1e-6 (bit for bit "
        f"{out['bit_for_bit']}); {seconds:.1f} s")
    return out


# ------------------------ slice 19: model-sharded members over a model axis
def _mp_cut(agent, tree, shard):
    """This rank's parts of a whole population tree (leaves (N, ...)), in a
    flat (N, P_local) buffer laid out as the rank's own."""
    from repro_torch.models.sharding import local_tree
    from repro_torch.tree import flat_copy
    dims = agent.shard_dims(tree, shard)
    return flat_copy(local_tree(tree, dims, shard))[0]


def _mp_parity_rank(rank, world, job):
    """53. For each of MP's archs at full width, MP["layers"] layers,
    float32: this rank's parts of N members over one island of model 2
    (``LMAgent.population_init(shard=...)``), 2 islands-backend steps (the
    first at lr 0 under warmup), then the same 2 steps of the whole
    members on this rank alone (the vectorized backend), and this rank's
    parts held to them by the LM update rule (the parameters after step 1
    bit for bit; the gradients from Adam's first moment at rtol 1e-4, atol
    1e-6; the step p - p' where both steps' reference gradients exceed
    1e-6). Then member 0's initial parameters in bf16, forward without
    autograd on the rank's parts (its kernels launched at the rank's local
    heads), whose RMS error from the float32 one-rank forward may be at
    most BF16_TP_RMS_RATIO times the one-rank bf16 forward's; and the same
    prompt served at model 2 with 8 decode steps, held the same way to
    the whole member's decode (:func:`_decode_held`)."""
    from repro_torch.data.lm_pipeline import host_batches
    from repro_torch.elastic import plan_layout
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.mesh import model_shard
    from repro_torch.models import lm
    from repro_torch.models.sharding import (local_tree, member_dims,
                                             model_parallel)
    from repro_torch.pop import LMAgent
    from repro_torch.pop.backend import make_update
    from repro_torch.tree import flat_buffer, tree_map

    out = {}
    for arch, n in MP["parity"]:
        cfg = _lm_config(arch, num_layers=MP["layers"], dtype="float32")
        agent = LMAgent(cfg, TrainConfig(total_steps=2, warmup_steps=1),
                        device="cuda")
        layout = plan_layout(world, n, preferred_model=world)
        shard = model_shard(layout.mesh)
        stream = host_batches(cfg.vocab_size, n * MP["batch"],
                              MP["seq_len"], seed=SEED)
        batches = [{"tokens": torch.from_numpy(next(stream)).reshape(
            n, MP["batch"], MP["seq_len"]).cuda()} for _ in range(2)]
        h = _lm_hypers(n, "cuda")
        bufs = lambda s: (flat_buffer(s.params), flat_buffer(s.opt_state.mu))
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = agent.population_init(torch.Generator().manual_seed(SEED), n,
                                      shard=shard)
        member = tree_map(lambda x: x[0].clone(), state.params)
        update = make_update(agent, "islands", mesh=layout.mesh)
        reset_counts(pop_adam)
        state, _ = update(state, batches[0], h)
        p1, mu1 = (b.clone() for b in bufs(state))
        state, metrics = update(state, batches[1], h)
        torch.cuda.synchronize()
        steps_s = time.perf_counter() - t0
        adam = pop_adam.launches
        p2, mu2 = bufs(state)
        peak = torch.cuda.max_memory_allocated() - base
        p_local = p1.shape[1]
        loss = metrics["loss"].cpu()
        del state, update
        bf16 = cfg.replace(dtype="bfloat16")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 53)
        tokens = torch.randint(0, cfg.vocab_size,
                               (MP["forward_batch"], MP["forward_len"]),
                               generator=gen, device="cuda")
        reset_counts(flash_attention, wkv6)
        with torch.no_grad(), model_parallel(shard):
            got, _ = lm.forward(lm.cast_params(member, bf16), bf16,
                                {"tokens": tokens})
        torch.cuda.synchronize()
        launches = {"flash_attention": flash_attention.launches,
                    "flash_attention_by_route": dict(
                        flash_attention.launches_by_route),
                    "wkv6": wkv6.launches}
        del member
        gc.collect()
        torch.cuda.empty_cache()

        ref = agent.population_init(torch.Generator().manual_seed(SEED), n)
        whole = tree_map(lambda x: x[0].clone(), ref.params)
        p_whole = flat_buffer(ref.params).shape[1]
        ref_update = make_update(agent, "vectorized")
        ref, _ = ref_update(ref, batches[0], h)
        q1 = _mp_cut(agent, ref.params, shard)
        nu1 = _mp_cut(agent, ref.opt_state.mu, shard)
        ref, ref_metrics = ref_update(ref, batches[1], h)
        q2 = _mp_cut(agent, ref.params, shard)
        nu2 = _mp_cut(agent, ref.opt_state.mu, shard)
        del ref, ref_update
        with torch.no_grad():
            want, _ = lm.forward(lm.cast_params(whole, bf16), bf16,
                                 {"tokens": tokens})
            exact, _ = lm.forward(whole, cfg, {"tokens": tokens})
        # slice 22: the same prompt served at model 2, then 8 decode steps,
        # against the whole member's decode in bf16 and in float32
        feed = _decode_feed(cfg, tokens)
        whole_bf16 = lm.cast_params(whole, bf16)
        decode = _decode_rank(cfg, local_tree(
            whole_bf16, member_dims(whole_bf16, shard, lead=0), shard),
            shard, feed)
        dec_want, _ = _decode_logits(bf16, whole_bf16, feed)
        dec_exact, _ = _decode_logits(cfg, whole, feed)
        kernel = "wkv6" if arch.startswith("rwkv6") else "flash_attention"
        decode = _decode_held(f"model-sharded {arch} rank {rank}", decode,
                              dec_exact, dec_want, {kernel: MP["layers"]})
        del whole, whole_bf16, feed
        if not torch.equal(p1, q1):
            raise AssertionError(f"model-sharded {arch} rank {rank}: the "
                                 f"parameters after step 1 (lr 0) moved "
                                 f"apart from the one-rank run's")
        g_mp = (mu1 / 0.1, (mu2 - 0.9 * mu1) / 0.1)
        g_ref = (nu1 / 0.1, (nu2 - 0.9 * nu1) / 0.1)
        grad_share = max(tol_share(a, b, STEP1_GRAD_TOL)
                         for a, b in zip(g_mp, g_ref))
        keep = ((g_ref[0].abs() > LM_STEP_GRAD_FLOOR)
                & (g_ref[1].abs() > LM_STEP_GRAD_FLOOR))
        step_share = tol_share((p1 - p2)[keep], (q1 - q2)[keep],
                               STEP1_GRAD_TOL)
        rms = lambda a: a.float().sub(exact).square().mean().sqrt().item()
        rms_ratio = rms(got) / rms(want)
        out[arch] = {
            "population": n, "p_local": p_local, "p_whole": p_whole,
            "member_bytes_local": 3 * 4 * p_local,
            "member_bytes_whole": 3 * 4 * p_whole,
            "pop_adam_launches": adam, "steps_s": steps_s,
            "peak_bytes": peak,
            "loss": loss.tolist(), "loss_one_rank":
                ref_metrics["loss"].cpu().tolist(),
            "grad_share": grad_share, "step_share": step_share,
            "step_elements_held": int(keep.sum()),
            "elements": keep.numel(),
            "logits_share": rms_ratio / BF16_TP_RMS_RATIO,
            "logits_rms_err": rms(got), "logits_rms_err_one_rank": rms(want),
            "logits_max_abs_err": (got.float() - want.float()).abs()
            .max().item(),
            "forward_shape": (MP["forward_batch"], MP["forward_len"]),
            "launches": launches, "decode": decode}
        del got, want, exact, p1, p2, mu1, mu2, q1, q2, nu1, nu2
        gc.collect()
        torch.cuda.empty_cache()
    return out




def _mp_trainer(layout, ckpt, n=None):
    """MP_ISLANDS' LM population on the islands backend over ``layout``
    (None: a world of one), checkpointing into ``ckpt``."""
    from repro_torch.configs import HyperSpace, TrainConfig
    from repro_torch.configs.base import PopulationConfig
    from repro_torch.pop import LMAgent, PopTrainer
    c = MP_ISLANDS
    n = n or c["population"]
    cfg = _lm_config(c["arch"])
    pcfg = PopulationConfig(size=n, strategy="pbt", backend="islands",
                            pbt_interval=0,
                            hyper_space=HyperSpace(**LM_HYPER_SPACE))
    return PopTrainer(LMAgent(cfg, TrainConfig(total_steps=4,
                                               warmup_steps=1),
                              device="cuda"),
                      pcfg, seed=SEED, layout=layout, checkpoint_dir=ckpt)


def _mp_islands_rank(rank, world, job):
    """54. MP_ISLANDS over 4 ranks, 2 islands x model 2: 2 steps, then an
    evolve on fitness [4, 3, 2, 1] (member 3, island 1, adopts member 0,
    island 0) and a blocking checkpoint. Returns the rank's model
    coordinate, the digests of member 0's parts before the evolve (island
    0) and of member 3's after it (island 1), the lineage and the
    exchange's numbers."""
    from repro_torch.data.lm_pipeline import host_batches
    from repro_torch.elastic import plan_layout
    from repro_torch.tree import flat_buffer
    c = MP_ISLANDS
    n = c["population"]
    layout = plan_layout(world, n, preferred_model=2)
    tr = _mp_trainer(layout, job["ckpt"])
    stream = host_batches(tr.agent.cfg.vocab_size, n * c["batch"],
                          c["seq_len"], seed=SEED)
    for _ in range(2):
        tr.step({"tokens": torch.from_numpy(next(stream)).reshape(
            n, c["batch"], c["seq_len"]).cuda()})
    bufs = lambda: (flat_buffer(tr.state.params),
                    flat_buffer(tr.state.opt_state.mu),
                    flat_buffer(tr.state.opt_state.nu))
    rows = tr.rows
    sent = [_digest(b[0]) for b in bufs()] if rows.lo == 0 else None
    tr.report_fitness(torch.tensor([4.0, 3.0, 2.0, 1.0], device="cuda"))
    lineage = tr.evolve().tolist()
    got = [_digest(b[n - 1 - rows.lo]) for b in bufs()] \
        if rows.hi == n else None
    exchange = dict(tr.strategy.gather.last)
    tr.save(blocking=True)
    return {"coord": layout.model_coord(), "island": layout.island_of(),
            "p_local": bufs()[0].shape[1], "sent": sent, "got": got,
            "lineage": lineage, "exchange": exchange}


def _mp_restore_rank(rank, world, job):
    """54, the other way: the one-rank checkpoint restored onto 2 ranks at
    model 2 by ``restore_elastic``; this rank's state leaves, on the
    host."""
    from repro_torch.elastic import plan_layout, restore_elastic
    from repro_torch.tree import leaves
    layout = plan_layout(world, MP_ISLANDS["population"], preferred_model=2)
    tr = _mp_trainer(layout, job["ckpt"])
    step, _ = restore_elastic(tr)
    return {"coord": layout.model_coord(), "step": step,
            "leaves": [x.cpu() for x in leaves(tr.state)],
            "dims": tr.agent.shard_dims(tr.state, tr.shard)}


def _mp_memory_run(n, shard=None, mesh=None):
    """55's population: MP_MEMORY's arch at full width, its layers,
    float32, one update step of the islands backend over ``mesh`` (or the
    vectorized one). Returns the bytes of the rank's parameters and
    moments, its peak of allocated memory over the run (above what was
    allocated before), its pop_adam launches and seconds."""
    from repro_torch.configs import TrainConfig
    from repro_torch.data.lm_pipeline import host_batches
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.pop import LMAgent
    from repro_torch.pop.backend import make_update
    from repro_torch.tree import flat_buffer
    c = MP_MEMORY
    cfg = _lm_config(c["arch"], num_layers=c["layers"], dtype="float32")
    agent = LMAgent(cfg, TrainConfig(total_steps=2, warmup_steps=1),
                    device="cuda")
    stream = host_batches(cfg.vocab_size, n * c["batch"], c["seq_len"],
                          seed=SEED)
    batch = {"tokens": torch.from_numpy(next(stream)).reshape(
        n, c["batch"], c["seq_len"]).cuda()}
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    where = {} if shard is None else {"shard": shard}
    state = agent.population_init(torch.Generator().manual_seed(SEED), n,
                                  **where)
    update = (make_update(agent, "islands", mesh=mesh) if mesh is not None
              else make_update(agent, "vectorized"))
    reset_counts(pop_adam)
    state, metrics = update(state, batch, _lm_hypers(n, "cuda"))
    torch.cuda.synchronize()
    out = {"state_bytes": 3 * 4 * flat_buffer(state.params).numel(),
           "peak_bytes": torch.cuda.max_memory_allocated() - base,
           "pop_adam_launches": pop_adam.launches,
           "seconds": time.perf_counter() - t0,
           "loss": metrics["loss"].cpu().tolist()}
    del state, update, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mp_memory_rank(rank, world, job):
    """55. MP_MEMORY's population over one island of model 2: this rank's
    bytes of parameters and moments and its peak of allocated memory."""
    from repro_torch.elastic import plan_layout
    from repro_torch.launch.mesh import model_shard
    layout = plan_layout(world, MP_MEMORY["population"],
                         preferred_model=world)
    return _mp_memory_run(MP_MEMORY["population"], model_shard(layout.mesh),
                          layout.mesh)


def _log_rank_rows(rows):
    """One line for each (name, row) of a kernel timed at a model-2 rank's
    shape."""
    for name, row in rows:
        log(f"{name} at a model-2 rank's shape {row['shape']}: == plain "
            f"(max abs err {row['max_abs_err']:.3g}, "
            f"{row['max_err_over_tolerance']:.3g} of {row['tolerance']}); "
            f"kernel {row['ms'] * 1e3:.3f} us, plain "
            f"{row['plain_ms'] * 1e3:.3f} us, library "
            f"{'none' if row['library_ms'] is None else '%.3f us' % (row['library_ms'] * 1e3)}"
            f", bound {row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})")


def _mp_kernel_rows():
    """flash_attention and wkv6 against their plain versions at the shapes
    a rank of model 2 gives them in phase 53's forward (qwen2-0.5b: 7 of
    14 heads over 1 of 2 kv heads, a GQA group of 7; rwkv6-1.6b: 16 of 32
    heads), timed beside their bounds (and SDPA for the attention); and
    pop_adam at a rank's (N, P_local) of phase 53's qwen2-0.5b."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.wkv6 import wkv6, wkv6_plain
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(SEED + 55)
    b, s = MP["forward_batch"], MP["forward_len"]
    rows = {}
    q, k, v = _flash_inputs(gen, b, 7, 1, s, 64, torch.bfloat16,
                            model_layout=True)
    got, want = flash_attention(q, k, v), flash_attention_plain(q, k, v)
    tol = FLASH_TOL[torch.bfloat16]
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **tol)
    bound, bound_by = flash_bound(b, 7, 1, s, 64)
    rows["flash_attention"] = {
        "shape": (b, 7, 1, s, 64), "dtype": "bfloat16", "route": "bf16_mma",
        "max_abs_err": (got.float() - want.float()).abs().max().item(),
        "max_err_over_tolerance": tol_share(got.float(), want.float(), tol),
        "tolerance": "rtol=atol=2e-2 (bf16)",
        "ms": graph_ms(lambda: flash_attention(q, k, v)),
        "plain_ms": graph_ms(lambda: flash_attention_plain(q, k, v),
                             reps=5, iters=5),
        "library_ms": graph_ms(lambda: sdpa(q, k, v, is_causal=True,
                                            enable_gqa=True)),
        "bound_ms": bound, "bound_by": bound_by}
    r, kk, vv, lw, u, state = _wkv6_inputs(gen, b, 16, s, 64,
                                           model_layout=True)
    got, got_state = wkv6(r, kk, vv, lw, u, state, chunk=64)
    want, want_state = wkv6_plain(r, kk, vv, lw, u, state, chunk=64)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **SCAN_TOL)
    torch.testing.assert_close(got_state, want_state, **SCAN_TOL)
    bound, bound_by = wkv6_bound(b, 16, s, 64)
    rows["wkv6"] = {
        "shape": (b, 16, s, 64), "chunk": 64,
        "max_abs_err": max((got - want).abs().max().item(),
                           (got_state - want_state).abs().max().item()),
        "max_err_over_tolerance": max(tol_share(got, want, SCAN_TOL),
                                      tol_share(got_state, want_state,
                                                SCAN_TOL)),
        "tolerance": "rtol=atol=2e-4",
        "ms": graph_ms(lambda: wkv6(r, kk, vv, lw, u, state, chunk=64)),
        "plain_ms": graph_ms(lambda: wkv6_plain(r, kk, vv, lw, u, state,
                                                chunk=64), reps=5, iters=5),
        "library_ms": None, "bound_ms": bound, "bound_by": bound_by}
    # pop_adam at a rank's (N, P_local) of phase 53's qwen2-0.5b
    from repro_torch.models import lm
    from repro_torch.models.sharding import tree_paths
    from repro_torch.tree import leaves
    arch, n = MP["parity"][0]
    cfg = _lm_config(arch, num_layers=MP["layers"])
    table, shapes = lm.shard_table(cfg, 2), lm.param_shapes(cfg)
    p_local = sum(x.numel() // (1 if table[path] is None else 2)
                  for path, x in zip(tree_paths(shapes), leaves(shapes)))
    adam = pop_adam_inplace_row(gen, n, p_local, f"{arch} model-2 rank")
    _log_rank_rows(rows.items())
    rows["pop_adam"] = adam
    return rows


def phase_model_sharded(root):
    """53-55. Model-sharded LM members on gloo ranks sharing cuda:0 (NCCL
    refuses two ranks on one GPU, so the model group's collectives go
    through the host; this checks correctness, launches and memory per
    rank, not speed across cards). 54 first: 4 ranks (2 islands x model
    2) exchange a member part by part and write a checkpoint, which this
    process restores at model 1 (every leaf bit for bit) and saves again;
    then one session of 2 ranks restores that onto model 2 (54's other
    way), runs 53's parity and 55's memory; then this process runs 55's
    one-rank reference and the kernels against their plain versions at
    the ranks' shapes."""
    from repro_torch.elastic import restore_elastic
    from repro_torch.models import lm
    from repro_torch.models.sharding import tree_paths
    from repro_torch.tree import leaves
    out = {}
    t0 = time.perf_counter()
    ckpt, ckpt1 = str(Path(root) / "m2"), str(Path(root) / "m1")
    isl = [r["islands"] for r in _spawn_session(
        [("islands", "_mp_islands_rank", {"ckpt": ckpt})], 4,
        Path(root) / "s4", MP["timeout"])]
    want = [0, 1, 2, 0]
    for r, res in enumerate(isl):
        if res["lineage"] != want:
            raise AssertionError(f"model-sharded islands rank {r}: lineage "
                                 f"{res['lineage']}, want {want}")
    for c in range(2):
        src = next(r for r in isl if r["island"] == 0 and r["coord"] == c)
        dst = next(r for r in isl if r["island"] == 1 and r["coord"] == c)
        if src["sent"] is None or src["sent"] != dst["got"]:
            raise AssertionError(f"model-sharded islands: member 3's parts "
                                 f"at model coordinate {c} after the evolve "
                                 f"are not member 0's before it")
    saved = _npz_leaves(sorted(Path(ckpt).glob("step_*"))[-1]
                        / "arrays.npz")
    one = _mp_trainer(None, ckpt1)
    template = [tuple(x.shape) for x in leaves(one.state)]
    if [x.shape for x in saved] != template:
        raise AssertionError("model-sharded islands: the checkpoint's "
                             "leaves are not the one-rank trainer's")
    restore_elastic(one, directory=ckpt)
    off = [i for i, (x, y) in enumerate(zip(leaves(one.state), saved))
           if not np.array_equal(x.cpu().numpy(), y)]
    if off:
        raise AssertionError(f"model-sharded: the model-2 checkpoint "
                             f"restored at model 1 differs in leaves {off}")
    one.save(blocking=True)
    saved1 = _npz_leaves(sorted(Path(ckpt1).glob("step_*"))[-1]
                         / "arrays.npz")
    del one
    out["islands"] = {"arch": MP_ISLANDS["arch"],
                      "population": MP_ISLANDS["population"],
                      "lineage": want, "exchange": [r["exchange"]
                                                    for r in isl],
                      "p_local": isl[0]["p_local"],
                      "checkpoint_leaves": len(saved),
                      "restored_model1_bit_for_bit": True}
    lap_s = time.perf_counter() - t0
    ranks = _spawn_session(
        [("restore", "_mp_restore_rank", {"ckpt": ckpt1}),
         ("parity", "_mp_parity_rank", {}),
         ("memory", "_mp_memory_rank", {})], 2, Path(root) / "s2",
        MP["timeout"])
    for r in ranks:
        res = r["restore"]
        for got, whole, dim in zip(res["leaves"], saved1, res["dims"]):
            if dim is not None:
                per = whole.shape[dim] // 2
                whole = np.take(whole, range(res["coord"] * per,
                                             (res["coord"] + 1) * per),
                                axis=dim)
            if not np.array_equal(got.numpy(), whole):
                raise AssertionError("model-sharded: the model-1 checkpoint "
                                     "restored at model 2 is not its parts")
    out["islands"]["restored_model2_bit_for_bit"] = True
    out["parity"] = {arch: [r["parity"][arch] for r in ranks]
                     for arch, _ in MP["parity"]}
    for arch, per_rank in out["parity"].items():
        for r, res in enumerate(per_rank):
            for what in ("grad_share", "step_share", "logits_share"):
                if not res[what] <= 1:
                    raise AssertionError(
                        f"model-sharded {arch} rank {r}: {what} "
                        f"{res[what]:.3g} of its tolerance from the "
                        f"one-rank run")
            if res["pop_adam_launches"] != 2:
                raise AssertionError(
                    f"model-sharded {arch} rank {r}: "
                    f"{res['pop_adam_launches']} pop_adam launches in 2 "
                    f"steps, want 1 a step")
            kernel = "wkv6" if arch.startswith("rwkv6") else \
                "flash_attention"
            if res["launches"][kernel] != MP["layers"]:
                raise AssertionError(
                    f"model-sharded {arch} rank {r}: "
                    f"{res['launches'][kernel]} {kernel} launches in the "
                    f"no-grad forward, want one a layer")
    mem = [r["memory"] for r in ranks]
    gc.collect()
    torch.cuda.empty_cache()
    one_rank = _mp_memory_run(MP_MEMORY["population"])
    # a rank's parameters and moments: half of every leaf the rules shard,
    # the whole of the rest
    cfg = _lm_config(MP_MEMORY["arch"], num_layers=MP_MEMORY["layers"])
    table = lm.shard_table(cfg, 2)
    want_bytes = 3 * 4 * MP_MEMORY["population"] * sum(
        x.numel() // (1 if table[p] is None else 2)
        for p, x in zip(tree_paths(lm.param_shapes(cfg)),
                        leaves(lm.param_shapes(cfg))))
    for r, res in enumerate(mem):
        if res["pop_adam_launches"] != 1:
            raise AssertionError(f"model-sharded memory rank {r}: "
                                 f"{res['pop_adam_launches']} pop_adam "
                                 f"launches in one step")
        if res["state_bytes"] != want_bytes:
            raise AssertionError(f"model-sharded memory rank {r}: "
                                 f"{res['state_bytes']} bytes of parameters "
                                 f"and moments, want {want_bytes} (the "
                                 f"one-rank run's {one_rank['state_bytes']})")
    out["memory"] = {"arch": MP_MEMORY["arch"], "layers": MP_MEMORY["layers"],
                     "population": MP_MEMORY["population"],
                     "ranks": mem, "one_rank": one_rank}
    out["kernels"] = _mp_kernel_rows()
    out["seconds"] = time.perf_counter() - t0
    out["islands_seconds"] = lap_s
    gb = lambda x: round(x / 1e9, 2)
    for arch, per_rank in out["parity"].items():
        a = per_rank[0]
        log(f"model-sharded {arch} ({MP['layers']} layers, fp32, "
            f"N={a['population']}) over 2 gloo ranks on cuda:0 at model 2: "
            f"P_local {[r['p_local'] for r in per_rank]} of "
            f"{a['p_whole']:,} a member ({gb(a['member_bytes_local'])} GB of "
            f"parameters and moments a member and rank against "
            f"{gb(a['member_bytes_whole'])}); pop_adam "
            f"{[r['pop_adam_launches'] for r in per_rank]} in 2 steps; vs "
            f"one rank: gradients {[r['grad_share'] for r in per_rank]}, "
            f"step {[r['step_share'] for r in per_rank]} of rtol 1e-4, atol "
            f"1e-6; bf16 forward {a['forward_shape']} launches "
            f"{a['launches']}, logits' RMS error from the float32 forward "
            f"{[round(r['logits_rms_err'], 5) for r in per_rank]} against "
            f"the one-rank bf16's {round(a['logits_rms_err_one_rank'], 5)} "
            f"(at most x{BF16_TP_RMS_RATIO}; max abs err against the "
            f"one-rank bf16 "
            f"{max(r['logits_max_abs_err'] for r in per_rank):.3g}); peak "
            f"allocated {[gb(r['peak_bytes']) for r in per_rank]} GB")
        log(_decode_line(arch, [r["decode"] for r in per_rank]))
    log(f"model-sharded islands ({MP_ISLANDS['arch']}, 2 islands x model 2 "
        f"over 4 ranks): lineage {want}, member 0's parts in member 3's "
        f"slot bit for bit at both model coordinates; exchange "
        f"{[r['exchange'] for r in isl]}; the checkpoint restored at model "
        f"1 and back at model 2 bit for bit")
    log(f"model-sharded memory ({MP_MEMORY['arch']}, {MP_MEMORY['layers']} "
        f"layer, N={MP_MEMORY['population']}): parameters and moments "
        f"{[gb(r['state_bytes']) for r in mem]} GB a rank against "
        f"{gb(one_rank['state_bytes'])} on one; peak allocated "
        f"{[gb(r['peak_bytes']) for r in mem]} GB a rank against "
        f"{gb(one_rank['peak_bytes'])}; {out['seconds']:.1f} s in all")
    return out


# ------- slice 20: model-sharded members of the MoE, MLA and Mamba2 families
def _mpf_sample_indices(shapes, count, seed):
    """For each leaf of one member's tree of ``shapes`` (its whole leaves),
    up to ``count`` distinct flat indices drawn from a seeded generator
    (sorted; none for an empty leaf)."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for shape in shapes:
        numel = int(np.prod(shape))
        idx = torch.randint(0, max(numel, 1), (min(count, numel),),
                            generator=gen)
        out.append(torch.unique(idx))
    return out


def _mpf_values(tree, idx):
    """Every member's values of each leaf of the population ``tree``
    (leaves (N, ...)) at that leaf's flat indices, on the host, float32."""
    from repro_torch.tree import leaves
    return [x.reshape(x.shape[0], -1)[:, i.to(x.device)].float().cpu()
            for x, i in zip(leaves(tree), idx)]


def _mpf_local(idx, shape, dim, coord, size):
    """Of a whole leaf's flat indices ``idx`` (a member's leaf of
    ``shape``), those in the part that model coordinate ``coord`` of
    ``size`` holds along ``dim`` (None: whole): (a mask over ``idx``,
    their flat indices in the part)."""
    if dim is None:
        return torch.ones(idx.shape, dtype=torch.bool), idx
    multi = list(np.unravel_index(idx.numpy(), shape))
    per = shape[dim] // size
    lo = coord * per
    held = (multi[dim] >= lo) & (multi[dim] < lo + per)
    multi = [m[held] for m in multi]
    multi[dim] = multi[dim] - lo
    local = list(shape)
    local[dim] = per
    return (torch.from_numpy(held),
            torch.from_numpy(np.ravel_multi_index(multi, local)).long())


def _mpf_setup(arch, layers, device="cuda"):
    """MP_FAMILIES' config of ``arch`` at full width, ``layers`` layers,
    float32, its agent, its 2 update batches and hypers."""
    from repro_torch.configs import TrainConfig
    from repro_torch.data.lm_pipeline import host_batches
    from repro_torch.pop import LMAgent
    c = MP_FAMILIES
    n = c["population"]
    cfg = _lm_config(arch, num_layers=layers, dtype="float32")
    agent = LMAgent(cfg, TrainConfig(total_steps=2, warmup_steps=1),
                    device=device)
    stream = host_batches(cfg.vocab_size, n * c["batch"], c["seq_len"],
                          seed=SEED)
    batches = [{"tokens": torch.from_numpy(next(stream)).reshape(
        n, c["batch"], c["seq_len"]).to(device)} for _ in range(2)]
    return cfg, agent, batches, _lm_hypers(n, device)


def _mpf_reference(arch, layers):
    """56, the one-rank side, in this process with the card to itself:
    MP_FAMILIES' population of ``arch`` whole, member 0's initial
    parameters forward in bf16 (its MoE routing recorded) and in float32
    (replaying that routing), then 2 vectorized-backend steps (their
    routing recorded). Keeps on the host only what the ranks are held
    to: the losses, each leaf's values at its sampled indices after step
    1 (parameters, mu) and step 2 (parameters, mu), both forwards'
    logits, the routings and the tokens of the forward."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.ssd import ssd
    from repro_torch.models import lm
    from repro_torch.pop.backend import make_update
    from repro_torch.tree import flat_buffer, leaves, tree_map
    c = MP_FAMILIES
    n = c["population"]
    cfg, agent, batches, h = _mpf_setup(arch, layers)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = agent.population_init(torch.Generator().manual_seed(SEED), n)
    p_whole = flat_buffer(state.params).shape[1]
    shapes = [tuple(x.shape[1:]) for x in leaves(state.params)]
    idx = _mpf_sample_indices(shapes, c["samples"], SEED + 56)
    bf16 = cfg.replace(dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 56)
    tokens = torch.randint(0, cfg.vocab_size,
                           (c["forward_batch"], c["forward_len"]),
                           generator=gen, device="cuda")
    forward_routes = []
    member = tree_map(lambda x: x[0], state.params)
    reset_counts(flash_attention, ssd)
    with torch.no_grad():
        with moe_routes(forward_routes, replay=False):
            want, _ = lm.forward(lm.cast_params(member, bf16), bf16,
                                 {"tokens": tokens})
        launches = {"flash_attention": flash_attention.launches,
                    "ssd": ssd.launches}
        with moe_routes(list(forward_routes), replay=True) as own:
            exact, _ = lm.forward(member, cfg, {"tokens": tokens})
    want, exact = want.cpu(), exact.cpu()
    decode = {}
    if arch in MP_DECODE["archs_56"]:
        # slice 22: the whole member's decode, bf16 (routing recorded) and
        # float32 (replaying it), for the ranks' model-2 decode
        feed = _decode_feed(cfg, tokens)
        decode["routes"] = []
        with moe_routes(decode["routes"], replay=False):
            decode["want"], _ = _decode_logits(
                bf16, lm.cast_params(member, bf16), feed)
        with moe_routes(list(decode["routes"]), replay=True):
            decode["exact"], _ = _decode_logits(cfg, member, feed)
        decode["routes"] = [r.cpu() for r in decode["routes"]]
        del feed
    del member
    routes = []
    update = make_update(agent, "vectorized")
    reset_counts(pop_adam)
    with moe_routes(routes, replay=False):
        state, m1 = update(state, batches[0], h)
        after1 = (_mpf_values(state.params, idx),
                  _mpf_values(state.opt_state.mu, idx))
        state, m2 = update(state, batches[1], h)
        after2 = (_mpf_values(state.params, idx),
                  _mpf_values(state.opt_state.mu, idx))
    torch.cuda.synchronize()
    out = {"p_whole": p_whole, "shapes": shapes, "idx": idx,
           "after1": after1, "after2": after2,
           "loss": [m1["loss"].cpu(), m2["loss"].cpu()],
           "routes": [r.cpu() for r in routes],
           "forward_routes": [r.cpu() for r in forward_routes],
           "tokens": tokens.cpu(), "want": want, "exact": exact,
           "decode": decode,
           "launches": launches, "pop_adam_launches": pop_adam.launches,
           "fp32_own_routes_differ": own["differ"],
           "peak_bytes": torch.cuda.max_memory_allocated() - base,
           "seconds": time.perf_counter() - t0}
    del state, update, m1, m2, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mpf_rank(rank, world, job):
    """56, a rank of one island of model 2: its parts of the same members
    (``LMAgent.population_init(shard=...)``), member 0's initial parts
    forward in bf16 without autograd (the reference's routing replayed;
    its kernels launched at the rank's heads), then the same 2 steps on
    the islands backend (the routing replayed). Held here against the
    reference's samples that lie in this rank's parts: the parameters
    after step 1 (lr 0 under warmup) bit for bit, the gradients (from
    Adam's first moment) at rtol 1e-4, atol 1e-6, the step p - p' where
    both steps' reference gradients exceed 1e-6. Returns the shares, the
    masks of the samples it held, its launches, P_local, its peak memory
    and its bf16 logits."""
    from repro_torch.elastic import plan_layout
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.ssd import ssd
    from repro_torch.launch.mesh import model_shard
    from repro_torch.models import lm
    from repro_torch.models.sharding import model_parallel
    from repro_torch.pop.backend import make_update
    from repro_torch.tree import flat_buffer, tree_map

    arch, layers, ref = job["arch"], job["layers"], job["ref"]
    n = MP_FAMILIES["population"]
    cfg, agent, batches, h = _mpf_setup(arch, layers)
    layout = plan_layout(world, n, preferred_model=world)
    shard = model_shard(layout.mesh)
    coord = layout.model_coord()
    dims = agent.shard_dims(lm.param_shapes(cfg), shard, lead=0)
    local = [_mpf_local(i, s, d, coord, world)
             for i, s, d in zip(ref["idx"], ref["shapes"], dims)]
    held = [m for m, _ in local]
    pick = lambda tree: _mpf_values(tree, [i for _, i in local])
    want_at = lambda values: torch.cat([v[:, m].reshape(-1) for v, m in
                                        zip(values, held)])
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = agent.population_init(torch.Generator().manual_seed(SEED), n,
                                  shard=shard)
    p_local = flat_buffer(state.params).shape[1]
    bf16 = cfg.replace(dtype="bfloat16")
    member = tree_map(torch.clone, lm.cast_params(
        tree_map(lambda x: x[0], state.params), bf16))
    reset_counts(flash_attention, ssd)
    with torch.no_grad(), model_parallel(shard), moe_routes(
            list(ref["forward_routes"]), replay=True) as fwd_own:
        got, _ = lm.forward(member, bf16,
                            {"tokens": ref["tokens"].cuda()})
    torch.cuda.synchronize()
    launches = {"flash_attention": flash_attention.launches,
                "flash_attention_by_route": dict(
                    flash_attention.launches_by_route),
                "ssd": ssd.launches}
    got = got.cpu()
    decode = None
    if ref["decode_routes"] is not None:
        # slice 22: the prompt served on the rank's parts, 8 decode steps
        with moe_routes([r.cuda() for r in ref["decode_routes"]],
                        replay=True):
            decode = _decode_rank(cfg, member, shard, _decode_feed(
                cfg, ref["tokens"].cuda()))
    del member
    update = make_update(agent, "islands", mesh=layout.mesh)
    reset_counts(pop_adam)
    with moe_routes(list(ref["routes"]), replay=True) as own:
        state, m1 = update(state, batches[0], h)
        p1, mu1 = pick(state.params), pick(state.opt_state.mu)
        state, m2 = update(state, batches[1], h)
        p2, mu2 = pick(state.params), pick(state.opt_state.mu)
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    flat = lambda values: torch.cat([v.reshape(-1) for v in values])
    q1, nu1 = (want_at(v) for v in ref["after1"])
    q2, nu2 = (want_at(v) for v in ref["after2"])
    p1, mu1, p2, mu2 = (flat(v) for v in (p1, mu1, p2, mu2))
    g_mp = (mu1 / 0.1, (mu2 - 0.9 * mu1) / 0.1)
    g_ref = (nu1 / 0.1, (nu2 - 0.9 * nu1) / 0.1)
    keep = ((g_ref[0].abs() > LM_STEP_GRAD_FLOOR)
            & (g_ref[1].abs() > LM_STEP_GRAD_FLOOR))
    out = {"coord": coord, "p_local": p_local,
           "peak_bytes": torch.cuda.max_memory_allocated() - base,
           "steps_s": steps_s, "pop_adam_launches": pop_adam.launches,
           "launches": launches,
           "loss": [m1["loss"].cpu(), m2["loss"].cpu()],
           "params_after_step1_equal": bool(torch.equal(p1, q1)),
           "grad_share": max(tol_share(a, b, STEP1_GRAD_TOL)
                             for a, b in zip(g_mp, g_ref)),
           "step_share": tol_share((p1 - p2)[keep], (q1 - q2)[keep],
                                   STEP1_GRAD_TOL),
           "step_elements_held": int(keep.sum()), "samples": keep.numel(),
           "held": held,
           "routes_overridden": [own["differ"], own["choices"]],
           "forward_routes_overridden": [fwd_own["differ"],
                                         fwd_own["choices"]],
           "logits": got, "decode": decode}
    del state, update, m1, m2
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mpf_kernel_rows(p_locals):
    """ssd and flash_attention against their plain versions at the shapes
    a rank of model 2 gives them in phase 56's forward (zamba2-7b: 56 of
    112 SSD heads; qwen3-moe-30b-a3b: 16 of 32 q heads over 2 of 4 kv
    heads, a GQA group of 8; zamba2's shared block: 16 of 32 heads of
    112, MHA), timed beside their bounds (and SDPA for the attention);
    and pop_adam at each arch's rank part (N, P_local)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.ssd import ssd, ssd_plain
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(SEED + 57)
    b, s = MP_FAMILIES["forward_batch"], MP_FAMILIES["forward_len"]
    rows = {"flash_attention": {}, "pop_adam": {}}
    tol = FLASH_TOL[torch.bfloat16]
    for arch, (h, hkv, d) in (("qwen3-moe-30b-a3b", (16, 2, 128)),
                              ("zamba2-7b", (16, 16, 112))):
        q, k, v = _flash_inputs(gen, b, h, hkv, s, d, torch.bfloat16,
                                model_layout=True)
        got, want = flash_attention(q, k, v), flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        bound, bound_by = flash_bound(b, h, hkv, s, d)
        rows["flash_attention"][arch] = {
            "shape": (b, h, hkv, s, d), "dtype": "bfloat16",
            "route": "bf16_mma",
            "max_abs_err": (got.float() - want.float()).abs().max().item(),
            "max_err_over_tolerance": tol_share(got.float(), want.float(),
                                                tol),
            "tolerance": "rtol=atol=2e-2 (bf16)",
            "ms": graph_ms(lambda: flash_attention(q, k, v)),
            "plain_ms": graph_ms(lambda: flash_attention_plain(q, k, v),
                                 reps=5, iters=5),
            "library_ms": graph_ms(lambda: sdpa(q, k, v, is_causal=True,
                                                enable_gqa=True)),
            "bound_ms": bound, "bound_by": bound_by}
        del q, k, v, got, want
    h, p, n, chunk = 56, 64, 64, 256
    x, dt, a, bm, cm, state = _ssd_inputs(gen, b, h, s, p, n,
                                          model_layout=True)
    got, got_state = ssd(x, dt, a, bm, cm, state, chunk=chunk)
    want, want_state = ssd_plain(x, dt, a, bm, cm, state, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **SCAN_TOL)
    torch.testing.assert_close(got_state, want_state, **SCAN_TOL)
    bound, bound_by = ssd_bound(b, h, s, p, n)
    rows["ssd"] = {
        "shape": (b, h, s, p), "n": n, "chunk": chunk,
        "max_abs_err": max((got - want).abs().max().item(),
                           (got_state - want_state).abs().max().item()),
        "max_err_over_tolerance": max(tol_share(got, want, SCAN_TOL),
                                      tol_share(got_state, want_state,
                                                SCAN_TOL)),
        "tolerance": "rtol=atol=2e-4",
        "ms": graph_ms(lambda: ssd(x, dt, a, bm, cm, state, chunk=chunk)),
        "plain_ms": graph_ms(lambda: ssd_plain(x, dt, a, bm, cm, state,
                                               chunk=chunk), reps=5,
                             iters=5),
        "library_ms": None, "bound_ms": bound, "bound_by": bound_by}
    del x, dt, a, bm, cm, state, got, want, got_state, want_state
    _log_rank_rows([("ssd zamba2-7b", rows["ssd"])] + [
        (f"flash_attention {arch}", r)
        for arch, r in rows["flash_attention"].items()])
    torch.cuda.empty_cache()
    for arch, p_local in p_locals.items():
        rows["pop_adam"][arch] = pop_adam_inplace_row(
            gen, MP_FAMILIES["population"], p_local,
            f"{arch} model-2 rank")
    return rows


def phase_model_sharded_families(root):
    """56. Model-sharded members of the MoE, MLA and Mamba2 families on 2
    gloo ranks sharing cuda:0 (one island of model 2). For each arch the
    one-rank reference runs first, in this process with the card to
    itself (a qwen3-moe population of 2 with its moments and a step's
    gradient is about 40 GB, so two ranks could not each hold one beside
    their parts); it keeps only samples on the host. Then one session of
    2 ranks runs each arch's parts and holds them to the samples, and
    this process holds their bf16 logits against the one-rank bf16
    forward's RMS error from float32 and times the kernels at the ranks'
    shapes."""
    from repro_torch.models import lm
    c = MP_FAMILIES
    t0 = time.perf_counter()
    refs = {arch: _mpf_reference(arch, layers)
            for arch, layers in c["archs"]}
    ref_s = time.perf_counter() - t0
    jobs = [(arch, "_mpf_rank", {
        "arch": arch, "layers": layers,
        "ref": {**{k: refs[arch][k] for k in ("idx", "shapes", "after1",
                                              "after2", "routes",
                                              "forward_routes", "tokens")},
                "decode_routes": refs[arch]["decode"].get("routes")}})
        for arch, layers in c["archs"]]
    ranks = _spawn_session(jobs, 2, Path(root), c["timeout"])
    ranks_s = time.perf_counter() - t0 - ref_s
    out = {"archs": {}}
    for arch, layers in c["archs"]:
        ref = refs.pop(arch)
        per_rank = [r[arch] for r in ranks]
        exact = ref["exact"].cuda()
        rms = lambda a: a.cuda().float().sub(exact).square().mean().sqrt(
        ).item()
        one_rank_rms = rms(ref["want"])
        want = ref["want"].cuda().float()
        for r, res in enumerate(per_rank):
            res["logits_rms_err"] = rms(res["logits"])
            res["logits_share"] = (res["logits_rms_err"] / one_rank_rms
                                   / BF16_TP_RMS_RATIO)
            res["logits_max_abs_err"] = (res.pop("logits").cuda().float()
                                         - want).abs().max().item()
            for what in ("grad_share", "step_share", "logits_share"):
                if not res[what] <= 1:
                    raise AssertionError(
                        f"model-sharded {arch} rank {r}: {what} "
                        f"{res[what]:.3g} of its tolerance from the "
                        f"one-rank run")
            if not res["params_after_step1_equal"]:
                raise AssertionError(
                    f"model-sharded {arch} rank {r}: the parameters after "
                    f"step 1 (lr 0) moved apart from the one-rank run's")
            for got, want_loss in zip(res["loss"], ref["loss"]):
                torch.testing.assert_close(got, want_loss, rtol=1e-4,
                                           atol=0.0)
            res["loss"] = [x.tolist() for x in res["loss"]]
            if res["pop_adam_launches"] != 2:
                raise AssertionError(
                    f"model-sharded {arch} rank {r}: "
                    f"{res['pop_adam_launches']} pop_adam launches in 2 "
                    f"steps, want 1 a step")
            for kernel, count in c["launches"][arch].items():
                if res["launches"][kernel] != count:
                    raise AssertionError(
                        f"model-sharded {arch} rank {r}: "
                        f"{res['launches'][kernel]} {kernel} launches in the "
                        f"no-grad forward, want {count}")
        del exact, want
        if ref["decode"]:
            for r, res in enumerate(per_rank):
                res["decode"] = _decode_held(
                    f"model-sharded {arch} rank {r}", res["decode"],
                    ref["decode"]["exact"], ref["decode"]["want"],
                    c["launches"][arch])
        else:
            for res in per_rank:
                res.pop("decode")
        unheld = [i for i, masks in enumerate(zip(*(r["held"]
                                                    for r in per_rank)))
                  if not torch.stack(masks).any(0).all()]
        if unheld:
            raise AssertionError(f"model-sharded {arch}: sampled elements "
                                 f"of leaves {unheld} lie in no rank's part")
        for res in per_rank:
            res.pop("held")
        table = lm.shard_table(_lm_config(arch, num_layers=layers), 2)
        out["archs"][arch] = {
            "layers": layers, "population": c["population"],
            "p_whole": ref["p_whole"], "ranks": per_rank,
            "samples_per_leaf": c["samples"],
            "leaves": len(ref["shapes"]),
            "whole_leaves": [p for p, d in table.items() if d is None],
            "one_rank": {"loss": [x.tolist() for x in ref["loss"]],
                         "peak_bytes": ref["peak_bytes"],
                         "pop_adam_launches": ref["pop_adam_launches"],
                         "launches": ref["launches"],
                         "logits_rms_err": one_rank_rms,
                         "seconds": ref["seconds"],
                         "fp32_own_routes_differ":
                             ref["fp32_own_routes_differ"]}}
        del ref
        gc.collect()
    torch.cuda.empty_cache()
    out["kernels"] = _mpf_kernel_rows(
        {arch: a["ranks"][0]["p_local"] for arch, a in out["archs"].items()})
    out["seconds"] = time.perf_counter() - t0
    out["reference_seconds"] = ref_s
    out["ranks_seconds"] = ranks_s
    gb = lambda x: round(x / 1e9, 2)
    for arch, a in out["archs"].items():
        rs = a["ranks"]
        log(f"model-sharded {arch} ({a['layers']} layers, fp32, "
            f"N={a['population']}) over 2 gloo ranks on cuda:0 at model 2: "
            f"P_local {[r['p_local'] for r in rs]} of {a['p_whole']:,} a "
            f"member; peak allocated {[gb(r['peak_bytes']) for r in rs]} GB "
            f"a rank against {gb(a['one_rank']['peak_bytes'])} on one; "
            f"pop_adam {[r['pop_adam_launches'] for r in rs]} in 2 steps; "
            f"vs one rank at {a['leaves']} leaves x up to "
            f"{a['samples_per_leaf']} sampled elements a member (every one "
            f"held on some rank): parameters after step 1 bit for bit, "
            f"gradients {[r['grad_share'] for r in rs]}, step "
            f"{[r['step_share'] for r in rs]} of rtol 1e-4, atol 1e-6 "
            f"({[r['step_elements_held'] for r in rs]} steps held of "
            f"{[r['samples'] for r in rs]}); loss "
            f"{[[round(float(x), 6) for x in r['loss'][-1]] for r in rs]} "
            f"against {[round(x, 6) for x in a['one_rank']['loss'][-1]]}; "
            f"routing overridden by the replay "
            f"{[r['routes_overridden'] for r in rs]} (update), "
            f"{[r['forward_routes_overridden'] for r in rs]} (forward); "
            f"bf16 forward {(c['forward_batch'], c['forward_len'])} "
            f"launches {[r['launches'] for r in rs]}, logits' RMS error "
            f"from the float32 forward "
            f"{[round(r['logits_rms_err'], 5) for r in rs]} against the "
            f"one-rank bf16's {round(a['one_rank']['logits_rms_err'], 5)} "
            f"(at most x{BF16_TP_RMS_RATIO}; max abs err against the "
            f"one-rank bf16 "
            f"{max(r['logits_max_abs_err'] for r in rs):.3g}); steps "
            f"{[round(r['steps_s'], 1) for r in rs]} s")
        if "decode" in rs[0]:
            log(_decode_line(arch, [r["decode"] for r in rs]))
    log(f"model-sharded families: {out['seconds']:.1f} s in all (the "
        f"one-rank references {ref_s:.1f} s, the ranks {ranks_s:.1f} s)")
    return out


# ------------- slice 21: CEM over islands and model-sharded members, and
# the RL ensemble served over ranks
@contextlib.contextmanager
def _cem_clock():
    """CEM's bind and evolve timed, the card synchronised at each end:
    yields a dict whose ``"bind"`` and ``"evolve"`` lists get each call's
    seconds, in order."""
    from repro_torch.pop import strategy as strategy_mod
    seconds = {"bind": [], "evolve": []}
    real = {name: getattr(strategy_mod.CEM, name) for name in seconds}

    def timed(name):
        def call(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = real[name](self, *a, **kw)
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
            return result
        return call
    with mock.patch.object(strategy_mod.CEM, "bind", timed("bind")), \
            mock.patch.object(strategy_mod.CEM, "evolve", timed("evolve")):
        yield seconds


def _cem_row_bytes(n, p_local, islands):
    """(bind, evolve): the bytes of rows CEM broadcasts over ``islands``,
    reckoned: member 0's row at bind and the elites' at each evolve, a
    rank's ``p_local`` float32 columns of each; none on one island."""
    from repro_torch.configs.base import PopulationConfig
    from repro_torch.core.cem import cem_weights
    if islands == 1:
        return 0, 0
    elites = cem_weights(n, PopulationConfig(size=n).elite_frac).numel()
    return 4 * p_local, 4 * elites * p_local


def _cem_record(trainer, clock):
    """Wrap the trainer's CEM evolve to keep, at each call, this rank's
    actors before and after it, the fitness, the generator's state, the
    distribution before and after it (this rank's columns), and its
    ``seconds`` (from ``clock``, :func:`_cem_clock`'s)."""
    strat, evolve = trainer.strategy, trainer.strategy.evolve
    calls = []

    def recorded(generator, pop_state, hypers, fitness):
        pre = _cpu_leaves(trainer.agent.actor_params(pop_state))
        cem = [x.detach().cpu().clone() for x in strat.export_state()]
        gen = generator.get_state()
        out = evolve(generator, pop_state, hypers, fitness)
        calls.append({"pre": pre, "cem_pre": cem, "gen": gen,
                      "fitness": fitness.detach().cpu().clone(),
                      "post": _cpu_leaves(trainer.agent.actor_params(out[0])),
                      "cem_post": [x.detach().cpu().clone()
                                   for x in strat.export_state()],
                      "lineage": out[2].tolist(),
                      "seconds": clock["evolve"][-1]})
        return out
    strat.evolve = recorded
    return calls


def _cem_islands_run(rank, world, job):
    """CEM_ISLANDS' TD3 on this rank's island (or alone: world 1): bind,
    then 4 iterations with an evaluation and an evolve every 2. The
    actors and distribution after bind, every evolve's record
    (``_cem_record``) and the run's launch counts."""
    from repro_torch.configs.base import PopulationConfig
    from repro_torch.elastic import plan_layout
    from repro_torch.envs import make
    from repro_torch.pop import PopTrainer
    from repro_torch.rl import get_algo, make_agent

    c = CEM_ISLANDS
    env = make("pendulum")
    pcfg = PopulationConfig(size=c["population"], strategy="cem",
                            backend="islands", num_steps=c["updates"],
                            pbt_interval=c["pbt_interval"],
                            hyper_space=get_algo("td3").hyper_space)
    _reset_island_counts()
    with _cem_clock() as clock:
        tr = PopTrainer(make_agent("td3", env.spec, device="cuda"), pcfg,
                        seed=SEED, layout=plan_layout(world, c["population"])
                        if world > 1 else None)
        bind = {"actors": _cpu_leaves(tr.actors),
                "cem": [x.cpu() for x in tr.strategy.export_state()],
                "seconds": clock["bind"][-1]}
        tr.attach_rollout(env, num_envs=c["num_envs"],
                          collect_steps=c["collect_steps"],
                          batch_size=c["batch"])
        calls = _cem_record(tr, clock)
        _reset_island_counts()
        tr.run_env_loop(c["iters"], eval_every=c["pbt_interval"])
        torch.cuda.synchronize()
    return {"rows": tuple(tr.rows), "bind": bind, "evolves": calls,
            "counts": _island_counts()}


def _cem_isolated(calls):
    """Each recorded evolve of the ranks again on one rank: the ranks'
    actors before it put together, rank 0's generator state and
    distribution, the same fitness; returns (actors after, distribution
    after) of each."""
    from repro_torch.configs.base import PopulationConfig
    from repro_torch.envs import make
    from repro_torch.pop import PopTrainer
    from repro_torch.rl import make_agent
    from repro_torch.tree import flatten, unflatten

    c = CEM_ISLANDS
    tr = PopTrainer(make_agent("td3", make("pendulum").spec, device="cuda"),
                    PopulationConfig(size=c["population"], strategy="cem"),
                    seed=SEED)
    out = []
    for ranks in calls:
        first = ranks[0]
        _, treedef = flatten(tr.actors)
        whole = [torch.cat([r["pre"][i] for r in ranks]).cuda()
                 for i in range(len(first["pre"]))]
        state = tr.agent.with_evolvable_params(tr.state,
                                               unflatten(treedef, whole))
        tr.generator.set_state(first["gen"])
        tr.strategy.import_state([x.cuda() for x in first["cem_pre"]])
        new, _, lineage = tr.strategy.evolve(tr.generator, state, None,
                                             first["fitness"].cuda())
        out.append((_cpu_leaves(tr.agent.actor_params(new)),
                    [x.cpu() for x in tr.strategy.export_state()],
                    lineage.tolist()))
    return out


def phase_cem_islands(root):
    """57. CEM over islands (TD3 on pendulum at the repo's width, N = 8,
    B = 256): the run on one rank in this process, then on two gloo ranks
    sharing cuda:0 (2 islands of 4). Held: each rank's actors and
    distribution after bind are the one-rank run's, bit for bit; each
    rank's evolves in lockstep (the same generator state, distribution and
    fitness on both ranks) and equal, bit for bit, to the same evolve on
    one rank from the ranks' actors before it (the updates between them
    differ by rounding at N = 4 against 8: phase 49); lineage all -1; each
    rank's launches the one-rank run's (24 pop_matmul and 2 pop_adam an
    update step, at its 4 members). Then the train CLI with ``--strategy
    cem --backend islands`` as a world of one NCCL rank beside ``--backend
    vectorized``: their checkpoints bit for bit."""
    c = CEM_ISLANDS
    t0 = time.perf_counter()
    one = _cem_islands_run(0, 1, {})
    ranks = [r["cem"] for r in _spawn_session(
        [("cem", "_cem_islands_run", {})], 2, root, c["timeout"])]
    iso = _cem_isolated(list(zip(*[r["evolves"] for r in ranks])))
    n = c["population"]
    _, evolve_bytes = _cem_row_bytes(n, one["bind"]["cem"][0].numel(), 2)
    for r, res in enumerate(ranks):
        lo, hi, _ = res["rows"]
        for what, got, want in (
                ("actors", res["bind"]["actors"],
                 [x[lo:hi] for x in one["bind"]["actors"]]),
                ("distribution", res["bind"]["cem"], one["bind"]["cem"])):
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"CEM islands rank {r}: the {what} "
                                     f"after bind are not the one-rank "
                                     f"run's")
        if res["counts"] != one["counts"]:
            raise AssertionError(f"CEM islands rank {r}: launches "
                                 f"{res['counts']}, one rank's "
                                 f"{one['counts']}")
        if len(res["evolves"]) != c["iters"] // c["pbt_interval"]:
            raise AssertionError(f"CEM islands rank {r}: "
                                 f"{len(res['evolves'])} evolves")
        for k, (call, (post, cem, lineage)) in enumerate(zip(
                res["evolves"], iso)):
            other = ranks[1 - r]["evolves"][k]
            same = (torch.equal(call["gen"], other["gen"])
                    and torch.equal(call["fitness"], other["fitness"])
                    and all(torch.equal(a, b) for a, b in
                            zip(call["cem_pre"], other["cem_pre"])))
            if not same:
                raise AssertionError(f"CEM islands evolve {k}: the ranks "
                                     f"are not in lockstep")
            if not (all(torch.equal(g, w[lo:hi])
                        for g, w in zip(call["post"], post))
                    and all(torch.equal(g, w)
                            for g, w in zip(call["cem_post"], cem))
                    and call["lineage"] == lineage == [-1] * n):
                raise AssertionError(f"CEM islands rank {r} evolve {k}: "
                                     f"not the one-rank evolve of the same "
                                     f"population, bit for bit")
    out = {"population": n, "launches_one_rank": one["counts"],
           "launches_by_rank": [res["counts"] for res in ranks],
           "evolve_ms_one_rank": [1e3 * e["seconds"]
                                  for e in one["evolves"]],
           "evolve_ms_two_ranks": [max(1e3 * res["evolves"][k]["seconds"]
                                       for res in ranks)
                                   for k in range(len(iso))],
           "evolve_bytes_broadcast": [evolve_bytes] * len(iso),
           "bind_ms_one_rank": 1e3 * one["bind"]["seconds"],
           "bind_ms_two_ranks": max(1e3 * res["bind"]["seconds"]
                                    for res in ranks),
           "evolves_bit_for_bit": len(iso)}
    log(f"CEM over islands, TD3 pendulum N={n}, 2 gloo ranks on cuda:0: "
        f"bind == one rank's bit for bit ({out['bind_ms_one_rank']:.2f} ms "
        f"one rank, {out['bind_ms_two_ranks']:.2f} ms two); {len(iso)} "
        f"evolves in lockstep, each == the one-rank evolve of the ranks' "
        f"population bit for bit, lineage all -1; evolve ms one rank "
        f"{[round(x, 2) for x in out['evolve_ms_one_rank']]}, two ranks "
        f"{[round(x, 2) for x in out['evolve_ms_two_ranks']]} (elite rows "
        f"broadcast {out['evolve_bytes_broadcast']} bytes, reckoned, gloo "
        f"via the host); launches per rank {ranks[0]['counts']} = one rank's")

    # the CLI: islands as a world of one NCCL rank against vectorized
    argv = ["--algo", "td3", "--env", "pendulum", "--strategy", "cem",
            "--population", str(n), "--fused-linear", "--num-envs",
            str(c["num_envs"]), "--collect-steps", str(c["collect_steps"]),
            "--updates-per-iter", str(c["updates"]), "--batch",
            str(c["batch"]), "--steps", str(c["cli_iters"]),
            "--pbt-interval", str(c["pbt_interval"]), "--eval-every",
            str(c["pbt_interval"]), "--seed", str(SEED)]
    env = dict(__import__("os").environ, PYTHONPATH=str(SRC))
    runs = {}
    for backend in ("vectorized", "islands"):
        launch = [sys.executable] if backend == "vectorized" else [
            sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "1"]
        runs[backend] = subprocess.Popen(
            launch + ["-m", "repro_torch.launch.train", *argv, "--backend",
                      backend, "--ckpt-dir", str(Path(root) / backend)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    printed = {}
    for backend, proc in runs.items():
        stdout, stderr = proc.communicate(timeout=c["timeout"])
        if proc.returncode:
            raise AssertionError(f"CEM CLI --backend {backend} exited "
                                 f"{proc.returncode}:\n{stdout[-2000:]}\n"
                                 f"{stderr[-3000:]}")
        printed[backend] = stdout
    if "process group nccl over 1 rank" not in printed["islands"]:
        raise AssertionError("CEM CLI: no NCCL layout printed:\n"
                             + printed["islands"][-1500:])
    evolves = [re.findall(r"evolve at iter \d+: lineage=(\[[-\d, ]*\])",
                          printed[b]) for b in runs]
    if (evolves[0] != evolves[1]
            or len(evolves[0]) != c["cli_iters"] // c["pbt_interval"]):
        raise AssertionError(f"CEM CLI: evolves printed {evolves}")
    want_dir, leaves_n = Path(root) / "vectorized", 0
    for step in sorted(p.name for p in want_dir.iterdir()):
        for f in sorted((want_dir / step).glob("*.npz")):
            got = _npz_leaves(Path(root) / "islands" / step / f.name)
            want = _npz_leaves(f)
            if len(got) != len(want) or not all(
                    np.array_equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"CEM CLI: islands' {step}/{f.name} "
                                     f"is not vectorized's, bit for bit")
            leaves_n += len(want)
    out["cli_leaves_bit_for_bit"] = leaves_n
    out["seconds"] = time.perf_counter() - t0
    log(f"CEM CLI --strategy cem --backend islands (torch.distributed.run, "
        f"one NCCL rank) == --backend vectorized: {leaves_n} checkpoint "
        f"leaves bit for bit, the CEM state among them; phase 57 "
        f"{out['seconds']:.1f} s")
    return out


def _lm_cem_rank(rank, world, job):
    """LM_CEM_ISLANDS' qwen2-0.5b population under CEM on this rank's place
    of ``job["layout"]`` (islands, model): bind, 2 steps on the fitness
    given (the window's mean is it), optionally an async checkpoint, and
    an evolve. Digests of this rank's parameter buffer after bind, before
    and after the evolve; rank 0's whole distribution after it; the
    pop_adam launches of the steps; the bind's and evolve's seconds; the
    peak of allocated memory."""
    from repro_torch.elastic import IslandLayout
    from repro_torch.kernels.pop_adam import pop_adam

    islands, model = job["layout"]
    layout = IslandLayout(devices=islands * model, islands=islands, data=1,
                          model=model, population=LM_CEM_ISLANDS["population"])
    torch.cuda.reset_peak_memory_stats()
    with _cem_clock() as clock:
        tr = _lm_cem_trainer(layout, job.get("ckpt"))
        bind = {"digest": _digest(tr.agent.evolvable_buffer(tr.state)),
                "seconds": clock["bind"][-1]}
        reset_counts(pop_adam)
        pre = _lm_cem_steps(tr)
        adam = pop_adam.launches
        if job.get("ckpt"):
            tr.save()                  # async: written during the evolve
        tr.evolve()
    torch.cuda.synchronize()
    state = tr.strategy.checkpoint_state()
    tr.wait()
    out = {"rows": tuple(tr.rows), "coord": layout.model_coord(),
           "bind": bind, "pre": pre, "pop_adam": adam,
           "post": _digest(tr.agent.evolvable_buffer(tr.state)),
           "cem": None if state is None else [_digest(x.cuda())
                                              for x in state[:2]],
           "evolve": {"seconds": clock["evolve"][-1]},
           "p_local": tr.agent.evolvable_buffer(tr.state).shape[1],
           "peak_bytes": torch.cuda.max_memory_allocated()}
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _lm_cem_trainer(layout, ckpt=None):
    from repro_torch.configs import HyperSpace, TrainConfig
    from repro_torch.configs.base import PopulationConfig
    from repro_torch.pop import LMAgent, PopTrainer
    c = LM_CEM_ISLANDS
    cfg = _lm_config(c["arch"], num_layers=c["layers"], dtype="float32")
    pcfg = PopulationConfig(size=c["population"], strategy="cem",
                            backend="islands", pbt_interval=0,
                            hyper_space=HyperSpace(**LM_HYPER_SPACE))
    return PopTrainer(LMAgent(cfg, TrainConfig(total_steps=2, warmup_steps=1),
                              device="cuda"), pcfg, seed=SEED,
                      layout=layout, checkpoint_dir=ckpt)


def _lm_cem_steps(tr):
    """Two steps of this rank's rows on LM_CEM_ISLANDS' fitness; the digest
    of the parameter buffer after them."""
    from repro_torch.data.lm_pipeline import host_batches
    c = LM_CEM_ISLANDS
    n = c["population"]
    stream = host_batches(tr.agent.cfg.vocab_size, n * c["batch"],
                          c["seq_len"], seed=SEED)
    fitness = torch.tensor(c["fitness"], device="cuda")
    for _ in range(2):
        tokens = torch.from_numpy(next(stream)).reshape(
            n, c["batch"], c["seq_len"]).cuda()
        tr.step({"tokens": tokens}, fitness=fitness)
    torch.cuda.synchronize()
    return _digest(tr.agent.evolvable_buffer(tr.state))


def _lm_cem_parts(tr, rows, coord, model):
    """The digest of rank ``(rows, coord)``'s part of a one-rank trainer's
    parameter buffer."""
    from repro_torch.models.sharding import ModelShard
    buf = tr.agent.evolvable_buffer(tr.state)[rows[0]:rows[1]]
    if model == 1:
        return _digest(buf)
    parts = tr.agent.part_map(ModelShard(coord, model))
    return _digest(torch.stack([parts.local_of(row) for row in buf]))


def phase_lm_cem_islands(root):
    """58. CEM over qwen2-0.5b at full width, 2 layers, float32, N = 4: the
    one-rank run (bind, 2 steps, evolve) in this process, then two gloo
    ranks sharing cuda:0 at islands 1 x model 2 (writing an async
    checkpoint before the evolve) and islands 2 x model 1. Held: every
    rank's parameters after bind are its part of the one-rank run's, bit
    for bit; 1 pop_adam launch a rank and step. At 2 x 1 the steps are the
    one-rank run's bit for bit (whole members: phase 51), so the evolve is
    held to the one-rank run's; at 1 x 2 (the steps' sums split over the
    model ranks round otherwise) the checkpoint resumes on one rank, its
    distribution the one-rank bind's bit for bit, and the resumed evolve
    is each rank's parts after its evolve, bit for bit, rank 0's whole
    distribution after it too. Prints bind and evolve ms, the bytes of
    rows broadcast and each rank's peak of allocated memory against one
    rank's."""
    c = LM_CEM_ISLANDS
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with _cem_clock() as clock:
        ref = _lm_cem_trainer(None)
    layouts = {"1x2": (1, 2), "2x1": (2, 1)}
    per = {key: [] for key in layouts}
    for key, (islands, model) in layouts.items():
        n_per = c["population"] // islands
        for rank in range(islands * model):
            rows = ((rank // model) * n_per, (rank // model + 1) * n_per)
            per[key].append({"rows": rows, "coord": rank % model,
                             "bind": _lm_cem_parts(ref, rows, rank % model,
                                                   model)})
    bind_cem = [x.clone() for x in ref.strategy.export_state()]
    one = {"bind": {"seconds": clock["bind"][-1]}}
    pre = _lm_cem_steps(ref)
    for r in per["2x1"]:
        r["pre"] = _lm_cem_parts(ref, r["rows"], 0, 1)
    with _cem_clock() as clock:
        ref.evolve()
    one["evolve"] = {"seconds": clock["evolve"][-1]}
    for r in per["2x1"]:
        r["post"] = _lm_cem_parts(ref, r["rows"], 0, 1)
    want_cem_2x1 = [_digest(x) for x in ref.strategy.export_state()[:2]]
    one["peak_bytes"] = torch.cuda.max_memory_allocated()
    one["p"] = ref.agent.evolvable_buffer(ref.state).shape[1]
    del ref, pre
    gc.collect()
    torch.cuda.empty_cache()

    ckpt = str(Path(root) / "lm_cem")
    ranks = _spawn_session(
        [("1x2", "_lm_cem_rank", {"layout": (1, 2), "ckpt": ckpt}),
         ("2x1", "_lm_cem_rank", {"layout": (2, 1)})], 2, root,
        c["timeout"])
    # the checkpoint written at 1 x 2 resumes on one rank
    res = _lm_cem_trainer(None, ckpt)
    step = res.resume()
    resumed_cem = [x.clone() for x in res.strategy.export_state()]
    if step != 1 or not all(torch.equal(a, b)
                            for a, b in zip(resumed_cem, bind_cem)):
        raise AssertionError(f"LM CEM 1 x 2: the checkpoint (step {step}) "
                             f"does not hold the one-rank bind's "
                             f"distribution bit for bit")
    res.report_fitness(torch.tensor(c["fitness"], device="cuda"))
    res.evolve()
    for r in per["1x2"]:
        r["post"] = _lm_cem_parts(res, r["rows"], r["coord"], 2)
    want_cem_1x2 = [_digest(x) for x in res.strategy.export_state()[:2]]
    del res, bind_cem, resumed_cem
    gc.collect()
    torch.cuda.empty_cache()
    for key, want_cem in (("1x2", want_cem_1x2), ("2x1", want_cem_2x1)):
        for rank, (got, want) in enumerate(zip([r[key] for r in ranks],
                                               per[key])):
            checks = {"bind": got["bind"]["digest"] == want["bind"],
                      "post": got["post"] == want["post"],
                      "pop_adam": got["pop_adam"] == 2}
            if key == "2x1":
                checks["pre"] = got["pre"] == want["pre"]
            if rank == 0:
                checks["cem"] = got["cem"] == want_cem
            bad = [k for k, ok in checks.items() if not ok]
            if bad:
                raise AssertionError(f"LM CEM {key} rank {rank}: {bad} not "
                                     f"the one-rank run's, bit for bit "
                                     f"(pop_adam launches "
                                     f"{got['pop_adam']}, want 2)")
    out = {"arch": c["arch"], "layers": c["layers"],
           "population": c["population"], "p": one["p"],
           "bind_ms_one_rank": 1e3 * one["bind"]["seconds"],
           "evolve_ms_one_rank": 1e3 * one["evolve"]["seconds"],
           "peak_bytes_one_rank": one["peak_bytes"], "resumed_step": step}
    for key, (islands, _) in layouts.items():
        rs = [r[key] for r in ranks]
        bind_bytes, evolve_bytes = _cem_row_bytes(
            c["population"], rs[0]["p_local"], islands)
        out[key] = {"p_local": rs[0]["p_local"],
                    "bind_ms": [1e3 * r["bind"]["seconds"] for r in rs],
                    "bind_bytes": [bind_bytes] * len(rs),
                    "evolve_ms": [1e3 * r["evolve"]["seconds"] for r in rs],
                    "evolve_bytes": [evolve_bytes] * len(rs),
                    "peak_bytes": [r["peak_bytes"] for r in rs],
                    "pop_adam_launches": [r["pop_adam"] for r in rs]}
        log(f"LM CEM {c['arch']} {c['layers']} layers fp32 N="
            f"{c['population']} at islands x model {key} on 2 gloo ranks: "
            f"bind and evolve == one rank's bit for bit (P_local "
            f"{rs[0]['p_local']:,} of {one['p']:,}); bind ms "
            f"{[round(x, 1) for x in out[key]['bind_ms']]}, evolve ms "
            f"{[round(x, 1) for x in out[key]['evolve_ms']]} (one rank "
            f"{out['bind_ms_one_rank']:.1f} / "
            f"{out['evolve_ms_one_rank']:.1f}); rows broadcast at bind "
            f"{out[key]['bind_bytes']} and at the evolve "
            f"{out[key]['evolve_bytes']} bytes (reckoned; gloo via the "
            f"host); peak "
            f"a rank {[round(b / 2**30, 2) for b in out[key]['peak_bytes']]}"
            f" GiB, one rank {one['peak_bytes'] / 2**30:.2f} GiB; pop_adam "
            f"{out[key]['pop_adam_launches']} launches a rank in 2 steps")
    # pop_adam at a model rank's shape (2 x 1's (2, P) moves the same
    # bytes), held to plain and timed
    gen = torch.Generator(device="cuda").manual_seed(SEED + 58)
    out["kernels"] = {"1x2": pop_adam_inplace_row(
        gen, c["population"], out["1x2"]["p_local"],
        f"{c['arch']} CEM 1x2 rank")}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 58 took {out['seconds']:.1f} s")
    return out


def _write_dqn_population(ckpt_dir, step, fitness):
    """A seeded DQN population checkpoint on cartpole, as
    ``write_population`` writes TD3's."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.envs import make
    from repro_torch.rl import make_agent
    agent = make_agent("dqn", make("cartpole").spec, device="cuda")
    state = agent.population_init(torch.Generator().manual_seed(SEED),
                                  len(fitness))
    CheckpointManager(ckpt_dir).save(
        step, (state, {}),
        {"size": len(fitness), "fitness": [float(f) for f in fitness]},
        aux={"actors": agent.actor_params(state)})


def _serve_islands_argv(case, ckpt):
    algo, env, mode, ensemble = SERVE_ISLANDS["cases"][case]
    return ["--algo", algo, "--env", env, "--mode", mode, "--ensemble",
            str(ensemble), "--fused-linear", "--batch", str(BATCH),
            "--requests", str(SERVE_ISLANDS["requests"]), "--poll-every",
            "0", "--diversity-weight", "0.0", "--seed", str(SEED),
            "--ckpt-dir", ckpt]


def _serve_islands_rank(rank, world, job):
    """Each SERVE_ISLANDS case through ``repro_torch.launch.serve.main``
    with ``--islands`` on this rank (rank 0's requests): its answers, the
    set's members and this rank's slots, p50/p99, the pop_matmul launches
    a batch, and the answers held to the plain ensemble; then rank 0
    writes a newer TD3 checkpoint and every rank polls it."""
    import torch.distributed as dist
    from repro_torch.kernels.pop_matmul import pop_matmul
    from repro_torch.launch.serve import main as serve_main

    out, reports = {}, {}
    for case in SERVE_ISLANDS["cases"]:
        reset_counts(pop_matmul)
        report = serve_main(_serve_islands_argv(case, job[case]) +
                            ["--islands"])
        torch.cuda.synchronize()
        server = report.server
        batches = SERVE_ISLANDS["requests"] + 2
        err, near = 0.0, 0
        mode = SERVE_ISLANDS["cases"][case][2]
        reports[case] = report
        out[case] = {"answers": [a for _, a in report.batches],
                     "members": server.set.members.tolist(),
                     "rows": server.rows, "islands": server.islands,
                     "p50_ms": report.p50_ms, "p99_ms": report.p99_ms,
                     "pop_matmul": pop_matmul.launches,
                     "pop_matmul_per_batch": pop_matmul.launches / batches,
                     "block": server.rows[1] - server.rows[0]}
        if rank == 0:
            for obs, actions in report.batches:
                if mode == "vote":
                    near += check_votes(server, obs, actions)
                else:
                    err = max(err, check_answers(server, obs, actions))
            out[case].update(max_abs_err=err, near_ties=near)
    # a newer checkpoint promotes the same set on every rank
    watcher, server = reports["td3_mean"].watcher, reports["td3_mean"].server
    if rank == 0:
        write_population(job["td3_mean"], 10, SERVE_ISLANDS["newer_fitness"])
    dist.barrier()
    newer = watcher.poll(server)
    out["promotion"] = {"step": None if newer is None else newer.step,
                        "members": None if newer is None else
                        newer.members.tolist(), "rows": server.rows,
                        "event": watcher.events[-1]}
    return out


def phase_serve_islands(root):
    """59. The RL ensemble served over ranks: TD3 (8 actors, ``mean`` and
    ``best``) and DQN on cartpole (4 members, ``vote``) through ``serve
    --islands --fused-linear --batch 256``, on two gloo ranks sharing
    cuda:0 and as a world of one (this process, no group; and the TD3
    ``best`` run through ``torch.distributed.run`` as one NCCL rank). Held:
    the answers against the plain ensemble on rank 0 (``mean`` and ``best``
    at rtol = atol = 1e-5, ``vote`` exactly off near ties), against the
    world of one on every rank (``mean`` at the tolerance, ``best`` and
    ``vote`` exactly); each rank its island's block of the set, 3
    pop_matmul launches a batch a rank; a newer checkpoint promoting the
    same set on both ranks, re-split. Prints p50/p99 a batch beside the
    world of one's."""
    from repro_torch.kernels.pop_matmul import pop_matmul
    from repro_torch.launch.serve import main as serve_main

    c = SERVE_ISLANDS
    t0 = time.perf_counter()
    ckpts = {case: str(Path(root) / case) for case in c["cases"]}
    fitness = np.linspace(-40.0, 30.0, 8)[[3, 0, 7, 5, 1, 6, 2, 4]]
    for case, (algo, _, _, ensemble) in c["cases"].items():
        (write_population if algo == "td3" else _write_dqn_population)(
            ckpts[case], 0, fitness[:ensemble if algo == "dqn" else 8])
    nccl = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "repro_torch.launch.serve",
         *_serve_islands_argv("td3_best", ckpts["td3_best"]), "--islands"],
        env=dict(__import__("os").environ, PYTHONPATH=str(SRC)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    alone = {}
    for case in c["cases"]:
        reset_counts(pop_matmul)
        report = serve_main(_serve_islands_argv(case, ckpts[case]) +
                            ["--islands"])
        alone[case] = {"answers": [a for _, a in report.batches],
                       "p50_ms": report.p50_ms, "p99_ms": report.p99_ms,
                       "members": report.server.set.members.tolist(),
                       "pop_matmul": pop_matmul.launches}
    ranks = [r["serve"] for r in _spawn_session(
        [("serve", "_serve_islands_rank", ckpts)], 2, root, c["timeout"])]
    stdout, stderr = nccl.communicate(timeout=c["timeout"])
    if nccl.returncode or "process group nccl over 1 rank" not in stdout:
        raise AssertionError(f"serve --islands on one NCCL rank exited "
                             f"{nccl.returncode}:\n{stdout[-2000:]}\n"
                             f"{stderr[-3000:]}")
    last = json.loads(re.search(r"last actions\[:2\] = (.*)", stdout)[1])
    if not np.array_equal(np.asarray(last, np.float32),
                          alone["td3_best"]["answers"][-1][:2]):
        raise AssertionError("serve --islands on one NCCL rank: its last "
                             "answers are not the world of one's")
    out = {"cases": {}, "card_shared_by": 2}
    for case, (algo, env, mode, ensemble) in c["cases"].items():
        want = alone[case]
        block = ensemble // 2
        for r, res in enumerate(ranks):
            got = res[case]
            if (got["members"] != want["members"] or got["islands"] != 2
                    or got["rows"] != (r * block, (r + 1) * block)
                    or got["pop_matmul_per_batch"] != 3):
                raise AssertionError(
                    f"serve islands {case} rank {r}: members "
                    f"{got['members']} (one rank {want['members']}), "
                    f"islands {got['islands']}, slots {got['rows']}, "
                    f"{got['pop_matmul_per_batch']} pop_matmul launches a "
                    f"batch (want 3)")
            for a, b in zip(got["answers"], want["answers"]):
                if mode == "mean":
                    np.testing.assert_allclose(a, b, **TOL)
                elif not np.array_equal(a, b):
                    raise AssertionError(f"serve islands {case} rank {r}: "
                                         f"answers are not the world of "
                                         f"one's, exactly")
        res0 = ranks[0][case]
        out["cases"][case] = {
            "algo": algo, "mode": mode, "ensemble": ensemble,
            "block": block, "members": want["members"],
            "launches_by_rank": [res[case]["pop_matmul"] for res in ranks],
            "launches_world_of_one": want["pop_matmul"],
            "max_abs_err": res0["max_abs_err"],
            "near_ties": res0["near_ties"],
            "p50_ms": [res[case]["p50_ms"] for res in ranks],
            "p99_ms": [res[case]["p99_ms"] for res in ranks],
            "p50_ms_world_of_one": want["p50_ms"],
            "p99_ms_world_of_one": want["p99_ms"]}
        log(f"serve --islands {algo} {mode} E={ensemble} over 2 gloo ranks "
            f"on cuda:0 (a block of {block} a rank, 3 pop_matmul launches a "
            f"batch a rank): == plain ensemble (max abs err "
            f"{res0['max_abs_err']:.3g}, near ties {res0['near_ties']}), == "
            f"a world of one ({'rtol 1e-5' if mode == 'mean' else 'exactly'}"
            f"); p50/p99 a batch rank 0 {res0['p50_ms']:.3f} / "
            f"{res0['p99_ms']:.3f} ms, world of one "
            f"{want['p50_ms']:.3f} / {want['p99_ms']:.3f} ms")
    promos = [r["promotion"] for r in ranks]
    if (promos[0]["step"] != 10 or promos[0]["members"] != promos[1][
            "members"] or [p["rows"] for p in promos] != [(0, 4), (4, 8)]):
        raise AssertionError(f"serve islands promotion: {promos}")
    out["promotion"] = promos[0]
    # pop_matmul at a rank's block (E = 4 of 8, B = 256) and DQN's (2 of 4)
    out["kernels"] = {"td3": serve_block_rows(
        4, (("layer_0", 3, 256, "relu", True),
            ("layer_1", 256, 256, "relu", False),
            ("layer_2", 256, 1, "tanh", False))),
        "dqn": serve_block_rows(
        2, (("layer_0", 4, 256, "relu", True),
            ("layer_1", 256, 256, "relu", False),
            ("layer_2", 256, 2, "none", False)))}
    out["seconds"] = time.perf_counter() - t0
    log(f"serve islands: a newer checkpoint promoted {promos[0]['members']} "
        f"on both ranks, slots {[p['rows'] for p in promos]}; phase 59 "
        f"{out['seconds']:.1f} s")
    return out


def serve_block_rows(n, layers):
    """pop_matmul at a rank's serving block (``n`` members, B = 256) held
    to its plain version and timed beside its bound and ``baddbmm``+act,
    layer by layer; the batch's sums and the largest error."""
    from repro_torch.kernels.pop_matmul import pop_matmul, pop_matmul_plain
    gen = torch.Generator(device="cuda").manual_seed(SEED + 59)
    acts = {"none": lambda t: t, "relu": torch.relu, "tanh": torch.tanh}
    rows, worst, share = [], 0.0, 0.0
    for name, k, m, act, broadcast in layers:
        w = torch.randn((n, k, m), generator=gen, device="cuda") / k ** 0.5
        b = torch.randn((n, m), generator=gen, device="cuda")
        x = (torch.randn((BATCH, k), generator=gen, device="cuda")
             .unsqueeze(0).expand(n, BATCH, k) if broadcast else
             torch.randn((n, BATCH, k), generator=gen, device="cuda"))
        kernel = lambda: pop_matmul(x, w, b, activation=act)
        plain = lambda: pop_matmul_plain(x, w, b, activation=act)
        library = lambda: acts[act](torch.baddbmm(b[:, None, :], x, w))
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
        worst = max(worst, (got - want).abs().max().item())
        share = max(share, tol_share(got, want, TOL))
        bound, bound_by = pop_matmul_bound(n, BATCH, k, m,
                                           broadcast=broadcast)
        rows.append({"layer": name, "n": n, "b": BATCH, "k": k, "m": m,
                     "act": act, "ms": graph_ms(kernel),
                     "plain_ms": graph_ms(plain),
                     "library_ms": graph_ms(library), "bound_ms": bound,
                     "bound_by": bound_by})
    total = {key: sum(r[key] for r in rows)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"pop_matmul at a rank's serving block (N={n}, B={BATCH}, "
        f"{len(rows)} layers): == plain (max abs err {worst:.3g}); kernel "
        f"{total['ms'] * 1e3:.3f} us a batch, plain "
        f"{total['plain_ms'] * 1e3:.3f}, baddbmm+act "
        f"{total['library_ms'] * 1e3:.3f}, bound "
        f"{total['bound_ms'] * 1e3:.3f} us")
    return {**total, "bound_by": "bytes" if all(
        r["bound_by"] == "bytes" for r in rows) else "operations",
        "max_abs_err": worst, "max_err_over_tolerance": share,
        "per_launch": rows}


# ------------------- slice 22: a decode state over the model axis, the
# dry run on the meta device
def _decode_feed(cfg, tokens):
    """A prompt (``tokens``, B x S), then MP_DECODE["tokens"] single
    random tokens, drawn from the seed on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    return [tokens] + [torch.randint(0, cfg.vocab_size,
                                     (tokens.shape[0], 1), generator=gen,
                                     device="cuda")
                       for _ in range(MP_DECODE["tokens"])]


def _decode_logits(cfg, params, feed, shard=None):
    """The serve step over ``feed`` (the prompt's prefill, then one token a
    step) with a state of the prompt plus the tokens, ``shard``'s part of
    it with one: every step's last-position logits (B, steps, V) float32
    on the host, and the final state."""
    from repro_torch.models import lm
    b, s = feed[0].shape
    step = lm.make_serve_step(cfg, shard)
    state = lm.init_decode_state(cfg, b, s + len(feed) - 1, device="cuda",
                                 shard=shard)
    out = []
    for i, t in enumerate(feed):
        logits, state = step(params, {"tokens": t}, state,
                             0 if i == 0 else s + i - 1)
        out.append(logits[:, -1].float().cpu())
    return torch.stack(out, 1), state


def _decode_state_bytes(cfg, b, max_len, size):
    """(the whole decode state's bytes, a rank's bytes by the layout
    rule: a cut leaf's 1/size, the rest whole)."""
    from repro_torch.models import lm
    from repro_torch.models.sharding import decode_state_dims
    shapes = lm.decode_state_shapes(cfg, b, max_len)
    dims = decode_state_dims(cfg, shapes, size)

    def walk(tree, dim):
        if isinstance(tree, dict):
            parts = [walk(tree[k], dim[k]) for k in tree]
            return tuple(sum(x) for x in zip(*parts))
        shape, dtype = tree
        whole = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        return whole, whole // (size if dim is not None else 1)
    return walk(shapes, dims)


def _decode_rank(cfg, part_bf16, shard, feed):
    """A rank's bf16 decode on its parts (``part_bf16``) and its part of
    the state: its logits, launches (the prefill's kernels at the rank's
    heads; the decode steps are plain), its state's bytes against the
    rule's and the whole's, and its seconds."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.tree import leaves
    bf16 = cfg.replace(dtype="bfloat16")
    reset_counts(flash_attention, wkv6, ssd)
    t0 = time.perf_counter()
    got, state = _decode_logits(bf16, part_bf16, feed, shard)
    torch.cuda.synchronize()
    b, s = feed[0].shape
    whole, rule = _decode_state_bytes(bf16, b, s + len(feed) - 1,
                                      shard.size)
    out = {"logits": got, "seconds": time.perf_counter() - t0,
           "launches": {"flash_attention": flash_attention.launches,
                        "wkv6": wkv6.launches, "ssd": ssd.launches},
           "state_bytes": sum(x.numel() * x.element_size()
                              for x in leaves(state)),
           "state_bytes_rule": rule, "state_bytes_whole": whole}
    del state
    return out


def _decode_held(what, res, exact, want, launches):
    """Holds a rank's decode (``res`` from :func:`_decode_rank`) to the
    one-rank decode: its logits' RMS error from the float32 one-rank
    decode ``exact`` at most BF16_TP_RMS_RATIO times the one-rank bf16
    decode's (``want``), its state exactly the rule's part, its kernel
    launches ``launches`` (the forward's: the prefill's at the rank's
    heads, none in the decode steps). Returns the figures."""
    rms = lambda a: a.float().sub(exact).square().mean().sqrt().item()
    got = res.pop("logits")
    res["logits_rms_err"] = rms(got)
    res["logits_rms_err_one_rank"] = rms(want)
    res["logits_share"] = (res["logits_rms_err"]
                           / res["logits_rms_err_one_rank"]
                           / BF16_TP_RMS_RATIO)
    res["logits_max_abs_err"] = (got - want).abs().max().item()
    if not res["logits_share"] <= 1:
        raise AssertionError(f"{what}: the model-2 decode's logits are "
                             f"{res['logits_share']:.3g} of their tolerance "
                             f"from the one-rank decode")
    if res["state_bytes"] != res["state_bytes_rule"]:
        raise AssertionError(f"{what}: the decode state holds "
                             f"{res['state_bytes']} bytes a rank, the "
                             f"layout rule's part is "
                             f"{res['state_bytes_rule']}")
    if {k: res["launches"][k] for k in launches} != launches:
        raise AssertionError(f"{what}: decode launches {res['launches']}, "
                             f"want {launches}")
    return res


def _decode_line(arch, per_rank):
    """The log line of a model-2 decode over its ranks."""
    gb = lambda x: round(x / 1e9, 4)
    a = per_rank[0]
    return (f"model-2 decode {arch} (bf16, prompt "
            f"{MP['forward_batch']} x {MP['forward_len']}, "
            f"{MP_DECODE['tokens']} decode steps): state "
            f"{[gb(r['state_bytes']) for r in per_rank]} GB a rank (the "
            f"rule's part) of {gb(a['state_bytes_whole'])} whole; launches "
            f"{[r['launches'] for r in per_rank]} (the prefill's, at the "
            f"rank's heads; the shapes of the forward's, held to the plain "
            f"versions in this phase's kernel rows); logits' RMS error from "
            f"the float32 one-rank decode "
            f"{[round(r['logits_rms_err'], 5) for r in per_rank]} against "
            f"the one-rank bf16's {round(a['logits_rms_err_one_rank'], 5)} "
            f"(at most x{BF16_TP_RMS_RATIO}; max abs err against the "
            f"one-rank bf16 "
            f"{max(r['logits_max_abs_err'] for r in per_rank):.3g}); "
            f"{[round(r['seconds'], 2) for r in per_rank]} s a rank; "
            f"{nvidia_smi_line()}")


def phase_dryrun_cell():
    """60. The dry run against the card: qwen2-0.5b x decode_32k on a mesh
    of 1 x 1 (a KV cache of 24 x 2 x 128 x 32,768 x 2 x 64 x 2 B = 51.5 GB
    and 0.99 GB of weights), reckoned by ``launch.dryrun.build_cell`` on
    the meta device, then the same decode step allocated and run on
    cuda:0. Held: the reckoned ``arguments`` bytes equal the bytes of the
    parameters, state and batch allocated, plus the int32 cache index the
    reckoning counts (a Python int here). Printed, not held: the reckoned
    peak against ``max_memory_allocated``, and the median of 5 decode
    steps (CUDA events) against the reckoned ``t_memory``. The cache is freed
    before the next phase."""
    from repro_torch.configs import LM_SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    from repro_torch.models.sharding import MeshShape
    from repro_torch.tree import leaves
    c = DRYRUN_CELL
    t0 = time.perf_counter()
    cfg, shape = get_config(c["arch"]), LM_SHAPES[c["shape"]]
    counter, info = dryrun.build_cell(c["arch"], c["shape"],
                                      mesh=MeshShape(("data", "model"),
                                                     (1, 1)))
    info = dryrun.analyze_cell(counter, info)
    reckon_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
    params = lm.init_params(gen, cfg, dtype=lm.compute_dtype(cfg))
    state = lm.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                 device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (shape.global_batch, 1),
                           generator=gen, device="cuda", dtype=torch.int32)
    nb = lambda tree: sum(x.numel() * x.element_size() for x in leaves(tree))
    allocated = nb(params) + nb(state) + nb(tokens)
    reckoned = info["bytes_per_device"]["arguments"]
    if reckoned != allocated + 4:
        raise AssertionError(f"dry run {c['arch']} x {c['shape']}: "
                             f"{reckoned} argument bytes reckoned, "
                             f"{allocated} allocated (+ 4 for the index)")
    step = lm.make_serve_step(cfg)
    index = shape.seq_len - 1
    # each step between its own CUDA events, after one warm step
    step(params, {"tokens": tokens}, state, index)
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
              for _ in range(c["steps"])]
    for start, end in events:
        start.record()
        step(params, {"tokens": tokens}, state, index)
        end.record()
    torch.cuda.synchronize()
    step_ms = sorted(start.elapsed_time(end) for start, end in events)
    ms = step_ms[len(step_ms) // 2]
    peak = torch.cuda.max_memory_allocated() - base
    reckoned_peak = reckoned + info["bytes_per_device"]["temps"]
    del params, state, tokens, step
    gc.collect()
    torch.cuda.empty_cache()
    out = {"arch": c["arch"], "shape": c["shape"], "mesh": info["mesh"],
           "arguments_reckoned": reckoned, "arguments_allocated": allocated,
           "cache_index_bytes": 4,
           "peak_reckoned": reckoned_peak, "peak_allocated": peak,
           "decode_ms": ms, "decode_ms_each": step_ms,
           "decode_steps": c["steps"],
           "t_memory_ms": 1e3 * info["t_memory"],
           "t_compute_ms": 1e3 * info["t_compute"],
           "bottleneck": info["bottleneck"],
           "traffic_bytes": info["hlo_traffic_bytes_per_device"],
           "flops": info["hlo_flops_per_device"],
           "reckon_s": reckon_s, "seconds": time.perf_counter() - t0}
    log(f"dry run {c['arch']} x {c['shape']} at 1 x 1, reckoned on the meta "
        f"device in {reckon_s:.1f} s: arguments {reckoned:,} bytes == the "
        f"{allocated:,} allocated (weights, KV cache, tokens) + 4 (the "
        f"index); peak reckoned {reckoned_peak / 1e9:.2f} GB against "
        f"max_memory_allocated {peak / 1e9:.2f} GB; a decode step "
        f"{ms:.3f} ms (median of {c['steps']}, CUDA events; "
        f"{step_ms[0]:.3f}-{step_ms[-1]:.3f}) against "
        f"t_memory {1e3 * info['t_memory']:.3f} ms (traffic "
        f"{info['hlo_traffic_bytes_per_device'] / 1e9:.2f} GB at 3.35 TB/s)"
        f"; {nvidia_smi_line()}")
    return out


def _cache_bytecode():
    """Keep the bytecode of every module this process and the processes it
    starts import under the checkout's ignored ``.pycache``: a machine that
    sets ``PYTHONDONTWRITEBYTECODE`` and ships no ``.pyc`` otherwise has
    every one of them (CLI runs, spawned ranks, ``torch.distributed.run``
    and its workers) compile torch's sources anew, about 8 s of CPU a
    process."""
    import os
    cache = str(ROOT / ".pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = cache
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = cache
    sys.dont_write_bytecode = False


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}"
              f"; run it from a checkout of the repository", file=sys.stderr)
        return 2
    _cache_bytecode()
    sys.path.insert(0, str(SRC))
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(SRC):
        print(f"chip_smoke: imported repro_torch from "
              f"{repro_torch.__file__}, not from this checkout",
              file=sys.stderr)
        return 2

    # 1. card
    device_name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device {device_name}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build: nvcc for the CUDA sources on a thread while Triton compiles
    from repro_torch.kernels import build
    from repro_torch.kernels.pop_adam import pop_adam
    built = {}

    def nvcc():
        t0 = time.perf_counter()
        built["reports"] = build.build(["pop_matmul", "wkv6", "ssd",
                                        "flash_attention", "hopper2d"])
        built["seconds"] = time.perf_counter() - t0

    thread = threading.Thread(target=nvcc)
    _start_fork_server()
    thread.start()
    t0 = time.perf_counter()
    one = torch.ones((1, 1), device="cuda")
    pop_adam(one, one, one, one, one[0], torch.ones(
        (1,), dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    thread.join()
    if "reports" not in built:
        raise RuntimeError("the nvcc build failed (see the thread's error)")
    log(f"built {sorted(built['reports']) or 'nothing (up to date)'} with "
        f"nvcc in {built['seconds']:.2f}s; pop_adam compiled by Triton and "
        f"launched once in {triton_s:.2f}s (in parallel)")
    figures = {src: ptxas_figures(text)
               for src, text in built["reports"].items()}
    # the bf16 flash route and ssd must run on the tensor cores: HMMA in
    # the SASS of each of their instantiations
    hmma = {k: c for k, c in sass_hmma_counts(
        build.library_path("flash_attention")).items()
        if "flash_mma_bf16" in k}
    ssd_hmma = sass_hmma_counts(build.library_path("ssd"))
    wkv6_hmma = sass_hmma_counts(build.library_path("wkv6"))
    label = kernel_labels([k for f in figures.values() for k in f]
                          + list(hmma) + list(ssd_hmma) + list(wkv6_hmma))
    ptxas = {}
    for src, kernels in figures.items():
        for kernel, (regs, st, ld, frame) in kernels.items():
            ptxas[label[kernel]] = {"registers": regs,
                                    "spill_store_bytes": st,
                                    "spill_load_bytes": ld,
                                    "stack_frame_bytes": frame}
            log(f"{src}: {label[kernel]} {regs} registers, spill stores "
                f"{st} bytes, spill loads {ld} bytes, stack frame {frame} "
                f"bytes")
    hmma = {label[k]: c for k, c in hmma.items()}
    from repro_torch.kernels.flash_attention import DIMS
    if len(hmma) != len(DIMS) or min(hmma.values()) == 0:
        raise AssertionError(f"flash_attention's bf16 instantiations must "
                             f"each hold HMMA instructions, found {hmma}")
    log("flash_attention bf16 route, HMMA instructions in the SASS: "
        + ", ".join(f"{k} {c}" for k, c in sorted(hmma.items())))
    from repro_torch.kernels.ssd import HEAD_DIMS, STATE_DIMS
    from repro_torch.kernels.wkv6 import DIMS as WKV6_DIMS
    # the chunked scans must run on the tensor cores and spill nothing
    scan_hmma = {}
    for name, counts, built in (
            ("ssd", ssd_hmma, len(HEAD_DIMS) * len(STATE_DIMS)),
            ("wkv6", wkv6_hmma, len(WKV6_DIMS))):
        counts = scan_hmma[name] = {label[k]: c for k, c in counts.items()}
        spills = {k: v for k, v in ptxas.items()
                  if k.startswith(name) and (v["spill_store_bytes"]
                                             or v["spill_load_bytes"])}
        if len(counts) != built or min(counts.values()) == 0 or spills:
            raise AssertionError(f"{name}'s instantiations must each hold "
                                 f"HMMA instructions and spill nothing, "
                                 f"found HMMA {counts}, spills {spills}")
        log(f"{name}, HMMA instructions in the SASS: "
            + ", ".join(f"{k} {c}" for k, c in sorted(counts.items())))

    # the command's seconds at the end of each group of phases
    seconds = {}
    lap = lambda name: seconds.__setitem__(
        name, round(time.perf_counter() - T_START, 1))
    lap("1-2 card, build")

    # 3. kernels vs plain, timing
    kernel_err, kernel_share, rows = phase_kernels()
    grad_err, train_fwd_err, train_share, train_rows = \
        phase_pop_matmul_training()
    adam_err, adam_share, adam_rows = phase_pop_adam()

    # 4. one population update, kernels vs plain
    update_grad_err, update_param_err = phase_update_parity()

    # 5. serve through the port's entry point
    serve, serve_err = phase_serve()

    # 6. train through the port's entry point, 7. serve what it trained
    # (the checkpoint stays for phase 42)
    train_dir = tempfile.TemporaryDirectory()
    train = phase_train(train_dir.name)
    trained_serve_err = phase_train_serve(train_dir.name,
                                          train["saved_fitness"])
    lap("3-7 TD3 kernels, update, serve, train")

    # 8. wkv6, ssd and flash_attention vs plain, timing; 9. the LM path,
    # card vs CPU; 10. LM serving through the port's entry point at full
    # size
    scans = {k: phase_scan_kernel(k) for k in ("wkv6", "ssd")}
    flash_err, flash_share, flash_rows = phase_flash_kernel()
    lm_parity = phase_lm_parity()
    lm_serve = phase_lm_serve()
    lap("8-10 LM kernels, parity, serve")

    # 11. pop_adam at the LM's size; 12. the LM update, card vs CPU; 13.
    # LM population training at full width; 14. the LM CLI, both
    # backends; 15. the paper's Fig. 2 unit
    torch.cuda.empty_cache()
    adam_lm_err, adam_lm_share, adam_lm_rows = phase_pop_adam_lm()
    lm_update = phase_lm_update_parity(LM_UPDATE)
    torch.cuda.empty_cache()
    lm_update_moe = phase_lm_update_parity(LM_UPDATE_MOE)
    torch.cuda.empty_cache()
    lm_train = phase_lm_train()
    lm_train["update_parity"] = lm_update
    lm_train["update_parity_moe"] = lm_update_moe
    lm_train["cli_final_loss"] = phase_lm_cli()
    lm_train["cli_final_loss_moe"] = {arch: phase_lm_cli(arch)
                                      for arch in MOE}
    fig2 = phase_fig2()
    lap("11-15 LM training, Fig. 2")
    # the LM train phase's model FLOPs a step (slice 16's accounting)
    slice16 = {"accounting": accounting_line(lm_train)}

    # 16. the shared-critic update, kernels vs plain; 17. its kernel
    # shapes; 18. CEM-RL and 19. DvD through the examples; 20. Fig. 4
    torch.cuda.empty_cache()
    shared = {"update_parity": phase_shared_update_parity()}
    shared_err, shared_share, shared_mm_rows, shared_adam_row = \
        phase_shared_kernels()
    shared["cemrl"] = phase_cemrl()
    shared["dvd"] = phase_dvd()
    fig4 = phase_fig4()
    lap("16-20 shared critic, CEM-RL, DvD, Fig. 4")

    # 21. SAC's and DQN's kernel shapes; 22. their updates, kernels vs
    # plain; 23. each trained and served through the entry points; 24. the
    # Atari torso, card vs CPU; 25. Fig. 2's SAC arm
    torch.cuda.empty_cache()
    sac_dqn = {"kernels": phase_sac_dqn_kernels()}
    for algo in SAC_DQN:
        sac_dqn[algo] = {"update_parity": phase_sac_dqn_update_parity(algo)}
        with tempfile.TemporaryDirectory() as ckpt_dir:
            sac_dqn[algo].update(phase_sac_dqn_train_serve(algo, ckpt_dir))
    sac_dqn["torso"] = phase_torso()
    fig2_sac = phase_fig2_arm("sac")
    lap("21-25 SAC, DQN, torso, Fig. 2 SAC")

    # 26. PPO's kernel shapes; 27. its update, kernels vs plain; 28. GAE,
    # card vs CPU; 29. trained and served through the entry points; 30.
    # Fig. 2's PPO arm
    torch.cuda.empty_cache()
    ppo = {"kernels": phase_ppo_kernels()}
    for env in PPO:
        ppo[env] = {"update_parity": phase_ppo_update_parity(env)}
    ppo["gae"] = phase_ppo_gae()
    for env in PPO:
        with tempfile.TemporaryDirectory() as ckpt_dir:
            ppo[env].update(phase_ppo_train_serve(env, ckpt_dir))
    ppo["fig2"] = phase_fig2_arm("ppo")
    lap("26-30 PPO")

    # 31. hopper2d's kernel vs plain; 32. fused epochs, captured vs eager;
    # 33. the acting engine at GPU-sim scale; 34. the train CLI's
    # acting-engine flags on hopper2d, each run served
    torch.cuda.empty_cache()
    acting = {"hopper2d": phase_hopper2d_kernel(
        {k: v for k, v in ptxas.items() if k.startswith("hopper2d")})}
    lap("31 hopper2d kernel")
    acting["fused"] = phase_fused_epochs()
    lap("32 fused epochs")
    acting["engine"], engine_launches = phase_acting_engine()
    lap("33 acting engine")
    with tempfile.TemporaryDirectory() as ckpt_root:
        acting["cli"] = phase_acting_cli(ckpt_root)
    lap("34 acting CLI")

    # 35. the frontend archs, card vs CPU; 36. each trained through the
    # train CLI at full width; 37. CEM over an LM's flat parameters,
    # chunked vs whole and through the CLI at full size; 38. pop_matmul
    # and pop_adam at the acting engine's update batch
    gc.collect()
    torch.cuda.empty_cache()
    frontends = {"parity": phase_frontend_parity()}
    lap("35 frontend parity")
    frontends["train"] = phase_frontend_train()
    lap("36 frontend training")
    lm_cem = phase_lm_cem()
    lap("37 LM CEM")
    acting["update_kernels"] = phase_acting_update_kernels()
    lap("38 acting update kernels")

    # 39. RL resume, fused and through the CLI; 40. LM resume through the
    # CLI at full width; 41. the fused epoch with a live sink; 42. the
    # serve CLIs with --log-dir and --profile
    gc.collect()
    torch.cuda.empty_cache()
    slice15 = {}
    with tempfile.TemporaryDirectory() as ckpt_root:
        slice15["resume_rl"] = phase_resume_rl(ckpt_root)
    lap("39 RL resume")
    # phase 40's step-2 checkpoint stays in lm_root for phase 45
    with tempfile.TemporaryDirectory() as lm_root, \
            tempfile.TemporaryDirectory() as rl_root:
        slice15["resume_lm"] = phase_resume_lm(Path(lm_root))
        lap("40 LM resume")
        slice15["sink"], sink_launches = phase_telemetry_sink()
        lap("41 telemetry sink")
        gc.collect()
        torch.cuda.empty_cache()
        slice15["serve"] = {"rl": phase_serve_telemetry_rl(train_dir.name),
                            "lm": phase_serve_telemetry_lm()}
        train_dir.cleanup()
        lap("42 serve telemetry")

        # 43. RL elastic resize, the trainer and the CLI; 44. the fused
        # engine resized; 45. the LM resized, from phase 40's checkpoint;
        # 46. DoubleBuffer; 47. the examples
        gc.collect()
        torch.cuda.empty_cache()
        slice16["elastic_rl"] = phase_elastic_rl(rl_root)
        lap("43 elastic RL")
        slice16["elastic_fused"] = phase_elastic_fused(rl_root)
        lap("44 elastic fused")
        gc.collect()
        torch.cuda.empty_cache()
        slice16["elastic_lm"] = phase_elastic_lm(Path(lm_root) / "resumed")
        lap("45 elastic LM")
        shutil.rmtree(Path(lm_root) / "resumed")
        slice16["double_buffer"] = phase_double_buffer()
        slice16["examples"] = phase_examples()
        lap("46-47 DoubleBuffer, examples")

    # 48. the islands CLI, a world of one NCCL rank; 49, 50, 52. two gloo
    # ranks sharing the card: TD3 islands, elastic across world sizes, the
    # DP reduction; 51. LM islands
    gc.collect()
    torch.cuda.empty_cache()
    slice18 = {}
    with tempfile.TemporaryDirectory() as root:
        slice18["cli"] = phase_islands_cli(root)
    lap("48 islands CLI, one NCCL rank")
    with tempfile.TemporaryDirectory() as root:
        slice18["ranks"] = phase_islands_ranks(root)
    lap("49-50, 52 islands, elastic and DP over two gloo ranks")
    with tempfile.TemporaryDirectory() as root:
        slice18["lm"] = phase_islands_lm(root)
    lap("51 LM islands")
    # 53-55. model-sharded LM members over an island's model axis: gloo
    # ranks sharing the card
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        for sub in ("s4", "s2"):
            (Path(root) / sub).mkdir()
        slice19 = phase_model_sharded(root)
    lap("53-55 model-sharded members")
    # 56. model-sharded members of the MoE, MLA and Mamba2 families
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        slice20 = phase_model_sharded_families(root)
    lap("56 model-sharded MoE, MLA and Mamba2 members")
    # 57. CEM over islands (TD3); 58. CEM over model-sharded LM members;
    # 59. the RL ensemble served over ranks: gloo ranks sharing the card
    gc.collect()
    torch.cuda.empty_cache()
    slice21 = {}
    with tempfile.TemporaryDirectory() as root:
        slice21["cem_islands"] = phase_cem_islands(root)
    lap("57 CEM over islands")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        slice21["lm_cem_islands"] = phase_lm_cem_islands(root)
    lap("58 CEM over model-sharded members")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        slice21["serve_islands"] = phase_serve_islands(root)
    lap("59 the ensemble served over ranks")
    # 60. the dry run's decode cell, reckoned on the meta device, then
    # allocated and stepped on the card
    gc.collect()
    torch.cuda.empty_cache()
    slice22 = {"dryrun_cell": phase_dryrun_cell(), "card": smi,
               "decode_model_2": {
                   **{arch: [r["decode"] for r in per_rank]
                      for arch, per_rank in slice19["parity"].items()},
                   **{arch: [r["decode"] for r in a["ranks"]]
                      for arch, a in slice20["archs"].items()
                      if "decode" in a["ranks"][0]}}}
    lap("60 the dry run's cell on the card")
    slice21["card"] = smi
    slice20["card"] = smi
    slice19["card"] = smi
    slice18["card"] = smi
    slice15["card"] = smi
    slice16["card"] = smi
    log(f"seconds at the end of each group of phases: {seconds}")
    # the islands runs: the one-rank run in this process and each of the
    # two gloo ranks' (a rank launches for the members it holds)
    isl = slice18["ranks"]["td3"]
    islands_paths = lambda name: {
        "islands_one_rank": isl["launches_one_rank"][name],
        **{f"islands_rank{r}": counts[name]
           for r, counts in enumerate(isl["launches_by_rank"])}}
    # a captured graph's launches are its captured launches times its
    # replays (plus the eager warm-up's before the capture)
    acting_paths = lambda name: {
        "fused_epochs": sum(r["launches"][name]
                            for r in acting["fused"].values()),
        "acting_engine": engine_launches[name],
        **{f"cli_{k}": r["launches"][name]
           for k, r in acting["cli"].items()},
        "resume_fused": slice15["resume_rl"]["fused"]["launches"][name],
        "fused_sink": sink_launches[name],
        "elastic_fused": slice16["elastic_fused"]["launches"][name],
        **islands_paths(name)}
    resume_cli = slice15["resume_rl"]["cli"]
    by_path = lambda name: {"td3_train": train["launches"][name],
                            "cemrl": shared["cemrl"]["launches"][name],
                            "dvd": shared["dvd"]["launches"][name],
                            **{f"{a}_train": sac_dqn[a]["launches"][name]
                               for a in SAC_DQN},
                            **{f"ppo_{e}_train": ppo[e]["launches"][name]
                               for e in PPO},
                            **acting_paths(name),
                            "resume_cli": resume_cli[name],
                            "elastic_rl": slice16["elastic_rl"][
                                "launches"][name],
                            "elastic_rl_cli": sum(
                                r["launches"][name] for r in
                                slice16["elastic_rl"]["cli"].values()),
                            "examples": slice16["examples"]["launches"][
                                name]}
    sac_dqn_entry = lambda kernel: {
        a: {"work": sac_dqn["kernels"][a]["work"],
            **sac_dqn["kernels"][a][kernel],
            "launches_per_update_step": (
                sac_dqn[a]["update_parity"]["pop_matmul_per_step"]
                if kernel == "pop_matmul" else SAC_DQN[a]["adam"]),
            "train_launches": sac_dqn[a]["launches"][kernel]}
        for a in SAC_DQN}
    ppo_entry = lambda kernel: {
        e: {"work": ppo["kernels"][e]["work"], **ppo["kernels"][e][kernel],
            "launches_per_update_step": (
                ppo[e]["update_parity"]["pop_matmul_per_step"]
                if kernel == "pop_matmul" else 1),
            "train_launches": ppo[e]["launches"][kernel]}
        for e in PPO}

    mp_parity = slice19["parity"]
    mp_paths = lambda name: {
        **{f"model_sharded_{arch}_rank{r}": res["launches"][name]
           for arch, per_rank in mp_parity.items()
           for r, res in enumerate(per_rank)},
        **{f"model_2_decode_{arch}_rank{r}": res["decode"]["launches"][name]
           for arch, per_rank in mp_parity.items()
           for r, res in enumerate(per_rank)}}
    mpf_archs = slice20["archs"]
    mpf_paths = lambda name: {
        **{f"model_sharded_{arch}_rank{r}": res["launches"][name]
           for arch, a in mpf_archs.items()
           for r, res in enumerate(a["ranks"])},
        **{f"model_2_decode_{arch}_rank{r}": res["decode"]["launches"][name]
           for arch, a in mpf_archs.items()
           for r, res in enumerate(a["ranks"]) if "decode" in res}}
    adam_paths = {**by_path("pop_adam"),
                  **{f"model_sharded_{arch}_rank{r}": res[
                      "pop_adam_launches"]
                     for arch, per_rank in mp_parity.items()
                     for r, res in enumerate(per_rank)},
                  **{f"model_sharded_{arch}_rank{r}": res[
                      "pop_adam_launches"]
                     for arch, a in mpf_archs.items()
                     for r, res in enumerate(a["ranks"])},
                  **{f"model_sharded_memory_rank{r}": res[
                      "pop_adam_launches"]
                     for r, res in enumerate(slice19["memory"]["ranks"])},
                  "lm_train": lm_train["launches"]["pop_adam"],
                  **{f"{a}_train": r["launches"]["pop_adam"]
                     for a, r in frontends["train"].items()},
                  "lm_cem": lm_cem["launches"]["pop_adam"],
                  "lm_resume": slice15["resume_lm"]["launches"][
                      "pop_adam"],
                  "elastic_lm": slice16["elastic_lm"]["launches"][
                      "pop_adam"]}
    # slice 21's paths: CEM over islands (one rank, each gloo rank), the
    # LM under CEM at each layout, and each served case over ranks
    cem21 = slice21["cem_islands"]
    lm21 = slice21["lm_cem_islands"]
    serve21 = slice21["serve_islands"]
    paths21 = lambda name: {
        "cem_islands_one_rank": cem21["launches_one_rank"][name],
        **{f"cem_islands_rank{r}": c[name]
           for r, c in enumerate(cem21["launches_by_rank"])}}
    mm_paths21 = {
        **paths21("pop_matmul"),
        **{f"serve_islands_{case}_rank{r}": n
           for case, c in serve21["cases"].items()
           for r, n in enumerate(c["launches_by_rank"])},
        **{f"serve_islands_{case}_world_of_one": c["launches_world_of_one"]
           for case, c in serve21["cases"].items()}}
    adam_paths.update(paths21("pop_adam"))
    adam_paths.update({f"lm_cem_{key}_rank{r}": n
                       for key in ("1x2", "2x1")
                       for r, n in enumerate(lm21[key][
                           "pop_adam_launches"])})
    per_batch = lambda key: sum(r[key] for r in rows)
    per_step = lambda key, rs: sum(r[key] * r["launches_per_update_step"]
                                   for r in rs)
    ops_share = per_step("bound_ms", [r for r in train_rows
                                      if r["bound_by"] == "operations"])
    mm_paths = {**by_path("pop_matmul"), "serve_telemetry": slice15[
        "serve"]["rl"]["launches"]["pop_matmul"], **mm_paths21}
    flash_paths = {**{f"serve_{arch}": r["launches"]["flash_attention"]
                      for arch, r in lm_serve.items()},
                   **mp_paths("flash_attention"),
                   **mpf_paths("flash_attention"),
                   "serve_qwen2-0.5b_telemetry": slice15["serve"]["lm"][
                       "launches"]["flash_attention"]}
    kernels = [{
        "name": "pop_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pop_matmul.cu",
        "replaces": "src/repro/kernels/pop_matmul.py:83",
        "redesigned_in": REDESIGNED_IN["pop_matmul"],
        # each main path, driven with the counts set to 0 just before
        "launches": sum(mm_paths.values()),
        "launches_by_path": mm_paths,
        "launches_by_route": train["pop_matmul_launches_by_route"],
        "max_abs_err": max(kernel_err, train_fwd_err, serve_err,
                           trained_serve_err, shared_err,
                           sac_dqn["kernels"]["max_abs_err"],
                           sac_dqn["sac"]["serve"]["max_abs_err"],
                           ppo["kernels"]["max_abs_err"],
                           ppo["pendulum"]["serve"]["max_abs_err"],
                           ppo["gae"]["value_max_abs_err"],
                           *[k["max_abs_err"] for k in
                             serve21["kernels"].values()],
                           *[c["max_abs_err"] for c in
                             serve21["cases"].values()]),
        "tolerance": "rtol=atol=1e-5",
        "grad_max_abs_err": max(grad_err,
                                sac_dqn["kernels"]["grad_max_abs_err"],
                                ppo["kernels"]["grad_max_abs_err"]),
        "grad_tolerance": "rtol=atol=1e-4",
        # max |kernel - plain| / (atol + rtol |plain|) over the forward and
        # gradient checks: at most 1 within tolerance
        "max_err_over_tolerance": max(kernel_share, train_share,
                                      shared_share,
                                      sac_dqn["kernels"]["share"],
                                      ppo["kernels"]["share"],
                                      *[k["max_err_over_tolerance"] for k
                                        in serve21["kernels"].values()]),
        "work": "the 24 forward launches of one TD3 update step (N=8, "
                "B=256); times are device times (CUDA graph replay, "
                "L2-warm)",
        "ms": per_step("ms", train_rows),
        "plain_ms": per_step("plain_ms", train_rows),
        "bound_ms": per_step("bound_ms", train_rows),
        "bound_by": ("operations" if 2 * ops_share >=
                     per_step("bound_ms", train_rows) else "bytes"),
        "library_ms": per_step("library_ms", train_rows),
        # the 12 backwards of one update step, each with the gradients
        # it is asked for
        "backward_bmm_ms": sum(r["backward_ms_per_step"]
                               for r in train_rows),
        "backward_bound_ms": sum(r["backward_bound_ms_per_step"]
                                 for r in train_rows),
        "per_launch_training": train_rows,
        "ptxas": {k: v for k, v in ptxas.items()
                  if k.startswith("pop_matmul")},
        "serve": {"launches": serve["mean"]["launches"],
                  "launches_by_route": serve["mean"]["launches_by_route"],
                  "work": f"the {len(rows)} launches of one served batch "
                          f"(E={ENSEMBLE}, B={BATCH})",
                  "ms": per_batch("ms"),
                  "plain_ms": per_batch("plain_ms"),
                  "bound_ms": per_batch("bound_ms"),
                  "library_ms": per_batch("library_ms"),
                  "eager_ms": per_batch("eager_ms"),
                  "plain_eager_ms": per_batch("plain_eager_ms"),
                  "per_launch": rows},
        "shared": {"work": f"the 6 forward launches of one shared-critic "
                           f"update step (N={SHARED['population']}, "
                           f"B={SHARED['batch']}, obs {SHARED['obs']}, act "
                           f"{SHARED['act']}) and the 3 of its DvD probe "
                           f"embedding (x ({SHARED['probe']}, "
                           f"{SHARED['obs']}) broadcast over the members)",
                   "ms": per_step("ms", shared_mm_rows),
                   "plain_ms": per_step("plain_ms", shared_mm_rows),
                   "bound_ms": per_step("bound_ms", shared_mm_rows),
                   "library_ms": per_step("library_ms", shared_mm_rows),
                   "launches_by_route": shared["cemrl"][
                       "pop_matmul_launches_by_route"],
                   "per_launch": shared_mm_rows},
        "sac_dqn": sac_dqn_entry("pop_matmul"),
        "ppo": ppo_entry("pop_matmul"),
        "serve_islands": {
            case: {"work": f"the 3 launches of one served batch on a "
                           f"rank's block ({c['block']} of E="
                           f"{c['ensemble']} members, B={BATCH}), "
                           f"{c['algo']}'s layers; device times, CUDA "
                           f"graph replay, L2-warm",
                   "launches_by_rank": c["launches_by_rank"],
                   **{k: v for k, v in serve21["kernels"][
                       c["algo"]].items() if k != "per_launch"}}
            for case, c in serve21["cases"].items()},
        "acting_update": {
            "work": acting["update_kernels"]["work"],
            **acting["update_kernels"]["pop_matmul"],
            "backward_bmm_ms": acting["update_kernels"][
                "pop_matmul_backward_ms"],
            "backward_bound_ms": acting["update_kernels"][
                "pop_matmul_backward_bound_ms"],
            "per_launch": acting["update_kernels"]["pop_matmul_rows"]},
    }, {
        "name": "pop_adam",
        "route": "triton",
        "source": "src/repro_torch/kernels/pop_adam.py",
        "replaces": "src/repro/kernels/pop_adam.py:53",
        # each main path, driven with the counts set to 0 just before
        "launches": sum(adam_paths.values()),
        "launches_by_path": adam_paths,
        "max_abs_err": max([adam_err, adam_lm_err,
                            sac_dqn["kernels"]["adam_max_abs_err"],
                            ppo["kernels"]["adam_max_abs_err"],
                            slice19["kernels"]["pop_adam"]["max_abs_err"]]
                           + [r["pop_adam"]["max_abs_err"]
                              for r in frontends["train"].values()]
                           + [r["max_abs_err"] for r in
                              slice20["kernels"]["pop_adam"].values()]
                           + [r["max_abs_err"] for r in
                              lm21["kernels"].values()]),
        "tolerance": "rtol=1e-5, atol=1e-6",
        "max_err_over_tolerance": max(
            [adam_share, adam_lm_share, sac_dqn["kernels"]["adam_share"],
             ppo["kernels"]["adam_share"],
             slice19["kernels"]["pop_adam"]["max_err_over_tolerance"]]
            + [r["pop_adam"]["max_err_over_tolerance"]
               for r in frontends["train"].values()]
            + [r["max_err_over_tolerance"] for r in
               slice20["kernels"]["pop_adam"].values()]
            + [r["max_err_over_tolerance"] for r in
               lm21["kernels"].values()]),
        "work": "the 2 launches of one TD3 update step (actor and critic, "
                "N=8); device times, CUDA graph replay, L2-warm",
        "ms": per_step("ms", adam_rows),
        "plain_ms": per_step("plain_ms", adam_rows),
        "bound_ms": per_step("bound_ms", adam_rows),
        "bound_by": "bytes",
        "library_ms": per_step("library_ms", adam_rows),
        "library_call": "torch._fused_adam_ with one lr shared by every "
                        "member",
        "per_launch": adam_rows,
        "lm": {"work": "one launch of the LM population's step (N=4, "
                       "qwen2-0.5b's P), with a decay and a clip scale "
                       "per member, and one at a ragged P past the old "
                       "grid; device times of eager launches, cold",
               "ms": adam_lm_rows[0]["ms"],
               "plain_ms": adam_lm_rows[0]["plain_ms"],
               "bound_ms": adam_lm_rows[0]["bound_ms"],
               "bound_by": adam_lm_rows[0]["bound_by"],
               "library_ms": adam_lm_rows[0]["library_ms"],
               "library_call": "torch._fused_adamw_ over the members' rows "
                               "with one lr and decay shared by all",
               "per_launch": adam_lm_rows},
        "shared": {"work": "the 1 launch of one shared-critic update step "
                           "(the policies' Adam, N=8, obs 17, act 6); "
                           "device times, CUDA graph replay, L2-warm",
                   **shared_adam_row},
        "sac_dqn": sac_dqn_entry("pop_adam"),
        "ppo": ppo_entry("pop_adam"),
        "frontends": {
            arch: {"work": f"one launch of {arch}'s vectorized step "
                           f"(N={r['population']}, {r['layers']} layers at "
                           f"full width), decay and clip scale, in place; "
                           f"device times of eager launches, cold",
                   **r["pop_adam"]}
            for arch, r in frontends["train"].items()},
        "model_sharded": {"work": "one launch of a model-2 rank's step "
                                  "over its parts of qwen2-0.5b's 4 "
                                  "members (2 layers), decay and clip "
                                  "scale, in place; device times of eager "
                                  "launches, cold",
                          **slice19["kernels"]["pop_adam"]},
        "model_sharded_families": {
            arch: {"work": f"one launch of a model-2 rank's step over its "
                           f"parts of {arch}'s 2 members "
                           f"({mpf_archs[arch]['layers']} layers at full "
                           f"width), decay and clip scale, in place; device "
                           f"times of eager launches, cold",
                   "launches_per_rank": [
                       r["pop_adam_launches"]
                       for r in mpf_archs[arch]["ranks"]], **row}
            for arch, row in slice20["kernels"]["pop_adam"].items()},
        "lm_cem": {"work": "qwen2-0.5b's population step under CEM, N=4: "
                           "the LM row's shape (lm above)",
                   "launches": lm_cem["launches"]["pop_adam"]},
        "lm_cem_islands": {
            key: {"work": f"one launch of a rank's step under CEM at "
                          f"islands x model {key} over qwen2-0.5b's 4 "
                          f"members (2 layers): ({row['n']}, {row['p']}), "
                          f"decay and clip scale, in place; device times "
                          f"of eager launches, cold",
                  "launches_per_rank": lm21[key]["pop_adam_launches"],
                  **row}
            for key, row in lm21["kernels"].items()},
        "acting_update": {
            "work": acting["update_kernels"]["work"],
            **acting["update_kernels"]["pop_adam"],
            "per_launch": acting["update_kernels"]["pop_adam_rows"]},
    }]
    for name, arch, per_prefill in (("wkv6", "rwkv6-1.6b", 24),
                                    ("ssd", "zamba2-7b", 81)):
        err, share, row = scans[name]
        paths = {f"serve_{arch}": lm_serve[arch]["launches"][name],
                 **(mp_paths(name) if name == "wkv6" else
                    mpf_paths(name))}
        sharded = (slice19["kernels"].get(name) if name == "wkv6"
                   else slice20["kernels"]["ssd"])
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": ("src/repro/kernels/wkv6.py:74" if name == "wkv6"
                         else "src/repro/kernels/ssd.py:71"),
            "redesigned_in": REDESIGNED_IN[name],
            "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": max([err, lm_parity[arch][0]]
                               + ([sharded["max_abs_err"]] if sharded
                                  else [])),
            "tolerance": "rtol=atol=2e-4 (kernel vs plain); 1e-3 (the "
                         "path, card vs CPU)",
            "max_err_over_tolerance": max(
                [share, lm_parity[arch][1]]
                + ([sharded["max_err_over_tolerance"]] if sharded else [])),
            "model_sharded": sharded,
            "work": f"one launch at the {arch} prefill's shape "
                    f"{row['shape']} (chunk {row['chunk']}), "
                    f"{per_prefill} per served prefill; device times, CUDA "
                    f"graph replay, L2-warm",
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "library_call": "none: no PyTorch call computes this function",
            "per_prefill_ms": row["ms"] * per_prefill,
            "ptxas": {k: v for k, v in ptxas.items() if k.startswith(name)},
            "hmma": scan_hmma[name],
        })
    head = flash_rows["qwen3-8b"]
    kernels.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "redesigned_in": REDESIGNED_IN["flash_attention"],
        "launches": sum(flash_paths.values()),
        "launches_by_arch": {arch: r["launches"]["flash_attention"]
                             for arch, r in lm_serve.items()},
        "launches_by_path": flash_paths,
        "launches_by_route": lm_serve["qwen3-8b"][
            "flash_attention_by_route"],
        "max_abs_err": max([flash_err] + [lm_parity[a][0] for a in DENSE]
                           + [lm_parity["qwen3-moe-30b-a3b"][0]]
                           + [e for e, _ in frontends["parity"].values()]
                           + [slice19["kernels"]["flash_attention"][
                               "max_abs_err"]]
                           + [r["max_abs_err"] for r in slice20["kernels"][
                               "flash_attention"].values()]),
        "tolerance": "rtol=atol=2e-4 float32, 2e-2 bf16 (kernel vs plain); "
                     "1e-3 (the path, card vs CPU)",
        "max_err_over_tolerance": max([flash_share]
                                      + [lm_parity[a][1] for a in DENSE]
                                      + [lm_parity["qwen3-moe-30b-a3b"][1]]
                                      + [s for _, s in
                                         frontends["parity"].values()]
                                      + [slice19["kernels"][
                                          "flash_attention"][
                                          "max_err_over_tolerance"]]
                                      + [r["max_err_over_tolerance"]
                                         for r in slice20["kernels"][
                                             "flash_attention"].values()]),
        "model_sharded": slice19["kernels"]["flash_attention"],
        "model_sharded_families": slice20["kernels"]["flash_attention"],
        "work": "one causal launch at the qwen3-8b prefill's shape "
                f"(B,H,Hkv,S,D)={head['shape']} bf16, 36 per served "
                "prefill; device times, CUDA graph replay, L2-warm",
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_call": "torch.nn.functional.scaled_dot_product_attention("
                        "is_causal=True, enable_gqa=True)",
        "per_launch": flash_rows,
        "bf16_hmma": hmma,
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith("flash")},
    })
    hop = acting["hopper2d"]
    hopper2d_paths = acting_paths("hopper2d")
    kernels.append({
        "name": "hopper2d",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hopper2d.cu",
        "replaces": "none: src/repro/envs/hopper2d.py:161 (_hopper2d_step) "
                    "has no pallas_call; XLA fuses the control step",
        "redesigned_in": REDESIGNED_IN["hopper2d"],
        "launches": sum(hopper2d_paths.values()),
        "launches_by_path": hopper2d_paths,
        "launches_by_route": {
            "vec": sum(acting_paths("hopper2d_vec").values()),
            "raw": sum(hopper2d_paths.values())
            - sum(acting_paths("hopper2d_vec").values())},
        "launches_counted": "the wrapper's count for eager launches; a "
                            "captured graph's as its captured launches "
                            "times its replays",
        "max_abs_err": hop["max_abs_err"],
        "tolerance": "rtol=atol=2e-4",
        "max_err_over_tolerance": hop["max_err_over_tolerance"],
        "off_the_bit": hop["off_the_bit"],
        "work": f"one launch of the vector env's whole step over "
                f"{hop['envs']} envs (8 members x 4,096 envs, "
                f"{hop['in_contact']} with a contact active), the main "
                f"paths' route; device times, CUDA graph replay, L2-warm",
        "ms": hop["ms"],
        "plain_ms": hop["plain_ms"],
        "plain_eager_ms": hop["plain_eager_ms"],
        "bound_ms": hop["bound_ms"],
        "bound_by": hop["bound_by"],
        "library_ms": None,
        "library_call": "none: no PyTorch call computes this function",
        "raw": hop["raw"],
        "limits": hop["limits"],
    })
    for mode, r in serve.items():
        log(f"serve {mode}: {r['req_per_s']:.1f} req/s, p50 "
            f"{r['p50_ms']:.4f} ms, p99 {r['p99_ms']:.4f} ms per batch")
    log(f"train: {train['iter_ms']:.2f} ms per iteration, "
        f"{train['member_update_step_ms'] * 1e3:.2f} us per "
        f"member-update-step, device busy share "
        f"{train['device_busy_share']}; update parity grads "
        f"{update_grad_err:.3g}, params {update_param_err:.3g}")
    for arch, r in lm_serve.items():
        log(f"serve {arch}: prefill {r['prefill_ms']:.2f} ms, "
            f"{r['decode_ms_per_token']:.3f} ms per decode step (batch "
            f"{LM_SERVE['batch']}, prompt {LM_SERVE['prompt_len']}, warm)")
    print(json.dumps({"train": {k: v for k, v in train.items()
                                if k != "evolutions"}}))
    print(json.dumps({"lm_serve": lm_serve}))
    print(json.dumps({"fig2": fig2}))
    print(json.dumps({"lm_train": lm_train}))
    print(json.dumps({"shared": shared}))
    print(json.dumps({"fig4": fig4}))
    print(json.dumps({"sac_dqn": sac_dqn}))
    print(json.dumps({"fig2_sac": fig2_sac}))
    print(json.dumps({"ppo": ppo}))
    print(json.dumps({"acting": acting, "phase_seconds": seconds}))
    print(json.dumps({"frontends": frontends}))
    print(json.dumps({"lm_cem": lm_cem}))
    print(json.dumps({"slice15": slice15}))
    print(json.dumps({"slice16": slice16}))
    slice18["seconds_total"] = round(time.perf_counter() - T_START, 1)
    print(json.dumps({"slice18": slice18}))
    print(json.dumps({"slice19": slice19}))
    print(json.dumps({"slice20": slice20}))
    print(json.dumps({"slice21": slice21}))
    print(json.dumps({"slice22": slice22}))
    log(f"the whole run took {slice18['seconds_total']} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
