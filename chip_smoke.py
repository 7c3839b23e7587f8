#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run it from a checkout of the repository; it puts ``src/`` on ``sys.path``
itself and needs one CUDA device.  Without one it exits non-zero and prints
no result.  The phases run in this order, and any failure ends the run with
a non-zero exit:

1. device       the card's name and power limit, as nvidia-smi reports them
2. build        every CUDA kernel of the port built from ``csrc/`` into
                ``build/repro_torch/``; ptxas's register, shared-memory,
                spill and wgmma lines, the build's seconds, and each
                flash-attention and mlstm_scan route's shared memory per
                block (and mlstm_scan's chunk and workspace per route)
3. kernel       each kernel (flash_attention, moe_gmm, rglru_scan,
                mlstm_scan) against its plain PyTorch version on the card,
                bf16 and float32, within the stated tolerances; at the
                serving shapes also kernel, plain and library (or yardstick)
                times and the card's bound for the same work (flash
                attention at minicpm's, granite-moe's, recurrentgemma's,
                llama-3.2-vision's and deepseek-coder-33b's prefill shapes
                and minicpm's on one rank of phase 41's (1, 4) mesh,
                h2o-danube-3-4b's past its window (S 5000, beside masked
                SDPA), hubert-xlarge's and minicpm-2b's train shapes (B 1,
                S 4096: 36 heads of 64, the shape phase 12 launches 160
                times a step), with kernel / SDPA
                as a factor; at hubert's head dim
                of 80, which the wrapper pads to 120, also the kernel alone
                on inputs padded beforehand); bf16 flash
                attention runs on the wgmma route, float32 on the scalar
                one; moe_gmm likewise (bf16 that TMA cannot address on its
                WMMA route), timed at granite-moe's prefill with every row
                live and at its and mixtral-8x7b's decode with a routing's
                bucket fills (only the touched experts' weights streamed),
                with the launches per route; mlstm_scan likewise (bf16
                that TMA cannot
                address on its scalar bf16 route), each case on the route
                its dtype and shape pick, with each pass of the wgmma route
                timed at the serving shape beside the scalar bf16 kernel,
                and also under stress with random keys, against the
                recurrence in float64; rglru_scan on both routes (gate
                biases fused in, whole gates), each timed at the serving
                shape beside its own bound (the fused route also at the
                train shape), its window and segment edges,
                and a long memory (a up to 0.9999, S 1000 and 4096) held
                against the recurrence in float64; and flash_attention's
                backward (kernel_bwd): through the wrapper's autograd
                function against the plain backward (explicit formulas in
                float32), bf16 (wgmma_bf16) and float32 (scalar_f32), MHA,
                GQA 24/8 and MQA (its query heads split over blocks),
                causal, not causal and biting windows, head dims 16, 64,
                80, 120, 128 and 256 (16 and 80 padded), S 1, 63, 65, 200,
                1000 and 4096 (the train phases' own shapes: minicpm-2b's
                36 heads of 64, recurrentgemma-9b's 16/1 at 256 with its
                window of 2048 and hubert-xlarge's 16 heads of 80, not
                causal, at one microbatch of 4096), each case
                checked to run on its route and, in bf16, to give the same
                bits on a second call, the forward's row log-sum-exp
                against the plain one, and at the three train shapes,
                minicpm's train shape on one rank of phase 42's (1, 4) mesh
                (9 of 36 heads) and minicpm's, granite's and
                recurrentgemma's prefill shapes the
                kernel, the plain version and SDPA's backward (with a band
                mask where the window bites: masked SDPA) timed beside the
                card's bound; then rglru_scan's backward
                (through ``ops.rglru``'s autograd function, bf16 and float32,
                the train shape B 1, S 4096, D 4096, the edges of its
                windows, many windows at narrower widths, B 2, x and ga
                off a 16-byte boundary, h0 and dh_last,
                both routes, each case repeated bit for bit; a long memory,
                a up to 0.9999 over 4096 steps, against autograd in float64;
                the train shape timed with each of its kernels) and
                mlstm_scan's backward (through ``ops.mlstm_chunkwise``'s,
                each case's backward on its forward's route, checked per
                case: bf16 on wgmma_bf16 (split-bf16 ``wgmma`` products on
                the states of each chunk of 128), Dh 37 in bf16 on
                scalar_bf16, float32 on scalar_f32: the train shape B 1, S
                4096, 4 heads of 1024, S 200 and 1, the denominator's floor
                active on most rows, an initial state, Dh 1600 and 37; the
                forward's row statistics against the plain ones), each
                against its plain backward, the train shape timed beside
                its bound (fixed at chunks of 64, as both routes are held
                to it), with each pass of the wgmma route and the scalar
                bf16 route's total beside it; and moe_gmm under grad
                (kernel_bwd moe_gmm: ``ExpertFFNFunction``, the kernel's
                forward and the backward kernel of ``csrc/moe_gmm_bwd.cu``
                on the same route, one launch each and no call of the
                plain backward) on every route, gated and not, bucket fills
                with pads that hold data (NaN in two cases) and an expert
                no token reached, at granite-moe's train shape (E 40, C
                1024, d 1536, f 512, a routing's 32768 live rows) and
                prefill shape: dxe, dw1, dw3, dw2 against the plain
                backward and autograd of the plain forward, dxe exactly 0
                on the pads; at the train shape the kernel repeated bit
                for bit and timed in turns with the plain backward, beside
                the function's forward and backward, plain autograd's and
                the bound
4. serve        full-width minicpm-2b (40 layers, bf16, random weights from a
                seed) serves 8 requests of 1000 prompt tokens through
                ``repro_torch.launch.serve.serve``; every prefill layer must
                have launched the flash-attention kernel, on its wgmma route
                (the launches per route are printed after each serve)
5. consistency  prefill + decode_step against forward_logits at full width in
                float32, with a negative control (an off-by-one position must
                fail the same tolerance)
6. serve        the same for full-width granite-moe-3b-a800m (32 layers, 40
                experts top-8) with ``moe_dispatch="gather"``: every MoE
                layer of every prefill and decode call must have launched the
                moe_gmm kernels, on their wgmma route, every attention layer
                of every prefill the flash kernel
7. consistency  the same for granite-moe in float32, at a capacity where no
                (token, expert) pair is dropped
8. serve        the same for full-width recurrentgemma-9b (38 layers: 26
                RG-LRU, 12 LOCAL attention with MQA at head dim 256): every
                RG-LRU layer of every prefill must have launched rglru_scan,
                on its fused_bias route, every LOCAL layer the flash kernel
9. consistency  the same for recurrentgemma-9b in float32, under its own
                bar (its decode state rounds the conv lag buffer to bf16)
10. serve       the same for full-width xlstm-1.3b, its depth cut to
                XLSTM_SERVE_LAYERS of 48 layers (12 mLSTM, 12 sLSTM, d 2048,
                4 heads, mLSTM head dim 1024; its sLSTM loop made it the
                longest serve phase, and the first cut as the script
                grew past 880 s): every mLSTM
                layer of every prefill must have launched mlstm_scan, on its
                wgmma route, and no other kernel runs; its prefill is
                profiled at 200 prompt
                tokens (the sLSTM's loop over time makes a 1000-token trace
                some 480,000 launches long)
11. consistency the same for xlstm-1.3b in float32, under its own bar (both
                blocks round their conv lag buffers to bf16); xLSTM reads no
                position, so its negative control feeds each decode step the
                previous token instead
12. train       full-width, full-depth minicpm-2b (40 layers, 2.725 B
                params) trains 4 AdamW steps (float32 master weights and
                moments, bf16 compute, remat "full", the wsd schedule at lr
                3e-4 with one warmup step) on one batch of 2 x 4096 tokens
                as 2 microbatches, then one eval step, through
                ``make_train_step`` / ``make_eval_step``: metrics finite,
                the loss after step 4 below step 1's, every step 160 flash
                forward launches (40 layers x 2 microbatches x forward and
                recompute, on wgmma_bf16) and 80 backward ones (on
                wgmma_bf16), no other kernel; step times, tokens/s, peak
                memory and a profiled step
13. train consistency  one float32 step of minicpm-2b at full width, 2
                layers, S 1024 (flash's scalar_f32 routes both ways): loss
                and every parameter's gradient on the card against the CPU's
                plain versions from the same weights (every norm scale drawn
                at 0.1 N(0, 1), as in every train consistency phase), with
                the labels shifted by one position as the negative control
                (every train consistency phase draws its weights on the
                card and runs its control there, the CPU taking the one
                step it is held against)
14. train       recurrentgemma-9b at full width, depth cut to 2 periods (4
                RG-LRU, 2 LOCAL layers, 3.41 B params), as phase 12 at
                2 x 4096: every step 16 rglru_scan and 8 flash forward
                launches (forward and recompute), 8 rglru_scan_bwd and 4
                flash backward ones, all on the bf16 routes; a profiled step
15. train consistency  recurrentgemma-9b, one period, float32, S 512
                (rglru_scan's fused_bias route both ways, flash's
                scalar_f32)
16. train       xlstm-1.3b at full width, depth cut to 2 periods (2 mLSTM,
                2 sLSTM layers), as phase 12 at 2 x 1024: every step 8
                mlstm_scan launches and 4 mlstm_scan_bwd, all on
                wgmma_bf16
17. train consistency  xlstm-1.3b, one period, float32, S 512 (mlstm_scan's
                scalar_f32 routes both ways)
18. serve       full-width, full-depth llama-3.2-vision-11b (40 layers: 32
                ATTN with GQA 32/8 at head dim 128, 8 gated CROSS layers;
                9.780 B params in bf16, every gate set to 0.5) serves 8
                requests of 1000 prompt tokens in 2 batches of 4, each
                batch with 1600 patches a row from ``vision_patches``,
                through ``make_prefill_step`` and ``make_serve_step`` (the
                serve loop takes no patches): 16 new greedy tokens a
                request, logits finite, every prefill 32 flash launches,
                causal, on wgmma_bf16, no decode step any (cross-attention
                computes on plain PyTorch); prefill and decode times, new
                tokens/s, peak memory, profiles, and one CROSS block's and
                its attention's CUDA-event times with their share of the
                prefill
19. consistency llama-3.2-vision-11b in float32, one period (4 ATTN, 1
                CROSS) at full width, S 512, gates 0.5 and norms drawn:
                prefill + 3 decode steps on the card against the CPU; the
                negative control feeds the card another image's patches
20. train       full-width, full-depth hubert-xlarge (48 layers, 0.945 B
                params) as phase 12, on frames with the masked-prediction
                loss: every step 192 flash forward and 96 backward
                launches, all not causal, on wgmma_bf16; then one encode
                (``forward_logits`` under ``inference_mode``) of 4 x 4096
                frames, 48 flash launches, not causal
21. train consistency  hubert-xlarge, 2 layers, float32, S 512; the
                negative control flips the mask
22. train       granite-moe-3b-a800m at full width, 4 layers, as phase 12,
                through the gather dispatch and the einsum dispatch from
                one init at capacity factor E / k = 5 (no pair drops):
                their losses within MOE_DISPATCH_RTOL of each other step by
                step, both falling; every gather step 16 moe_gmm launches
                (4 layers x 2 microbatches x forward and recompute, on
                wgmma_bf16), 8 backward launches (wgmma_bf16) and 16
                flash forward launches, no moe_gmm launch on einsum;
                after step 1 every expert of every layer and every router
                column has a non-zero gradient
23. train       granite-moe-3b-a800m at full width and depth (32 layers,
                3.374 B params) through the gather dispatch at its
                config's capacity factor: the loss after step 4 below
                step 1's, and the batch nll (each microbatch's, evaluated
                before and after the steps) falling; step times, tokens/s,
                peak memory, and a profiled step with the moe_gmm
                forward's and backward kernel's shares; then the
                einsum dispatch from the same init, its curves beside
24. train consistency  granite-moe, 2 layers, float32, S 512, capacity
                factor E / k: the gather step on the card against the
                CPU's plain step within 2e-5, and against einsum on the card
25. pipeline    the §5 single-cell pipeline's step bodies
                (``repro_torch.pipeline``) in the engine's order, each tool
                made by its factory from the declarative document's
                arguments: mkfastq, every sample's count (tiny_lm training:
                flash forward and backward), seurat (flash forward and
                k-means), singler, then the aggregate, whose summary must
                cover every sample; at the document's own arguments (32
                samples, d_model 48) and at 8 samples of 64 x 1024 tokens,
                d_model 1024, vocab 32768, 16 steps; per step kind the
                seconds, the flash launches and the device-busy share
26. pipeline consistency  one sample's count (4 steps) and seurat in
                float32 at d_model 256, card against CPU from one init:
                per-step losses, embeddings (the untrained model's as the
                control) and cluster assignments
27-34. serve and consistency, in turn, for the other four zoo configs
                (ZOO_ARCHS), each served as phase 4 serves minicpm-2b and
                with its launches checked the same way: h2o-danube-3-4b
                (24 layers, SWA window 4096, head dim 120) on prompts of
                5000 tokens, so that prefill ring-rotates its cache of 4096
                slots and decode wraps it; minitron-8b (32 layers, the
                non-gated relu2 MLP, an untied head of 256000 rows);
                deepseek-coder-33b (62 layers, 62.1 GiB of bf16 weights,
                56 query heads over 8 KV heads); mixtral-8x7b cut to 16 of
                its 32 layers (43.6 GiB) through gather, every MoE call of
                every prefill and decode step on moe_gmm's wgmma route.
                Each served model is freed before its consistency phase,
                which draws a float32 model of 2 layers at full width
                (norms drawn): prefill + 3 decode steps against
                forward_logits (B 1, S 4200 for the two windowed configs,
                past the window; B 2, S 200 else), the off-by-one position
                as the control, flash and moe_gmm on scalar_f32, mixtral
                with no (token, expert) pair dropped at capacity factor
                E / k; then forward_logits on the card against the CPU's
                plain path at B 1, S 128

35. train compressed  minicpm-2b at full width, 4 layers, as phase 12:
                4 steps of ``make_train_step_dp_compressed`` (the int8
                error-feedback all-reduce, ``optim.compression``) on a
                one-rank NCCL group beside 4 plain steps from the same init
                and batch: step 1's loss the same bits, every parameter
                after step 1 within 2 lr of the plain step's (and the
                reference test's 5e-2), the gradient used plus the new
                error equal to the gradient plus the old error on every
                leaf within float32 rounding, the loss falling, phase 12's
                launches per layer on wgmma_bf16, one int32 NCCL all-reduce
                a leaf; both steps' times and the all-reduce's share
36. train driver  ``examples/train_e2e_torch.py`` through
                ``launch/train.py`` on the card (minicpm-2b -smoke, batch
                8 x 128): 60 steps straight, and 40 steps then a second run
                that resumes from the checkpoint at 40 to 60; both final
                checkpoints the same bits; seconds a step, to save and to
                restore
37. dryrun      ``launch/dryrun.py``'s count of phase 12's step on ``meta``
                (no allocation): model FLOPs, counted FLOPs and their
                ratio, each kernel's counted calls equal to phase 12's
                launches a step, the predicted memory of the arguments
                beside phase 12's peak, and model FLOPs over (phase 12's
                step seconds x the bf16 peak) with the card's name and
                power limit
38. pipeline engine  run right after phase 26: the same two documents
                through the port's StreamFlow engine (``repro_torch.core``:
                ``load_streamflow_file``, ``StreamFlowExecutor.from_config``
                without speculation, ``run`` from seed 0), the occam mesh
                site's steps under its CUDA device and the cloud site's on
                the card too; against phase 25 from the same seed: each
                sample's cluster assignments and the type counts equal, the
                mean confidence, the count losses and every count model
                within stated bars (the bits expected equal); the flash
                launches as totals over the run (n (2 steps + 2) forward, n
                2 steps backward, all on wgmma_bf16, no other kernel); every
                invocation done at attempt 0, none speculative, each count
                and seurat invocation's resource printed; the makespan
                beside phase 25's serial sum, the data manager's transfers
                per kind and per link, the peak memory, and at the
                document's size the device-busy share of one profiled run
39. pipeline service  run right after phase 38: a ``WorkflowService``
                over the hybrid document's models (occam a mesh site on
                the GPU, garr_cloud a local site), two tenants of share 1,
                two runs at a time, one pool of sites, no cache; dict
                documents through ``submit_document``, lab_b's with an
                ``analyze:`` gate.  (a) seeds 0 and 1 for each tenant at
                the document's size: every run
                COMPLETE, the seed-0 runs phase 38's result (type counts,
                mean confidence, count losses under its bars, on each
                run's own outputs), the seed-1 runs each other's, 2 pooled
                deploys, the flash totals 4 x phase 38's on wgmma_bf16;
                (b) a journaled seed-0 run cancelled once its journal holds
                SERVICE_CANCEL_AFTER completed invocations, beside a seed-1
                run that completes: CANCELED within
                SERVICE_CANCEL_LIMIT_S, the journal ``cancelled``, and a
                new executor's resume to phase 38's result that re-runs no
                journaled invocation and launches flash for the others
                only; (c) one seed-0 run a tenant at PIPELINE_REAL at
                once, each phase 38's result, 2 x its launches; (d) the
                analyzer's makespan lower bound from each phase 38 run's
                least invocation seconds a step at most that run's span,
                and the bound from phase 25's standalone seconds beside
                it; each run's makespan, each batch's wall time and
                peak memory (batch (a)'s device-busy share is not
                measured since phase 41: the profiler's trace took ~54 s
                to read)
40. pipeline recovery  ``streamflow_doc_scatter_hybrid`` (the python
                builder, plan-identical to the declarative document) at
                the document's size, journaled with its payloads: a tick
                hook kills the driver once RECOVERY_CRASH_AFTER
                invocations have completed, with kernels in flight; a new
                executor resumes from the journal path alone to phase
                38's result, re-running no journaled invocation, its
                flash launches those of the re-run counts and seurats
41. sharded serve  run right after phase 5, on phase 4's minicpm-2b
                (full width, its first SHARDED_SERVE_LAYERS = 10 of 40
                layers, bf16, seed 0) under the ``base``
                ruleset: (a) on a one-rank NCCL group and a (1, 1)
                ("data", "model") mesh, a prefill of 4 x 1000 tokens into
                caches of 1024 slots (sequence-sharded by
                ``cache_specs``) and 16 greedy decode steps through
                ``make_prefill_step`` / ``make_serve_step`` with ``mesh=``,
                beside the same steps without a mesh: the same greedy
                tokens, the logits' largest difference under
                SHARDED_LOGITS_BAR, 10 flash launches a prefill on
                wgmma_bf16 (the counts reset just before the sharded steps
                and read just after), prefill ms (median of 3) and decode
                ms a step both ways; (b) rank 0 of a (1, 4) mesh of a fake
                process group (its collectives move nothing) on the card:
                the same prefill at 9 of 36 heads a rank, its ms and flash
                launches, one rank's compute with the collectives skipped
                (its outputs are not checked)
42. sharded train  run right after phase 35, on minicpm-2b at full width,
                COMPRESSED_LAYERS layers, phase 12's recipe (float32
                masters, bf16 compute, remat "full", 2 microbatches of 1 x
                4096) and the ``base`` ruleset: (a) on a one-rank NCCL
                group and a (1, 1) mesh, TRAIN_STEPS steps of
                ``make_train_step(mesh=)`` beside as many plain steps from
                the same init on the same batch: step 1's loss and
                grad_norm within TRAIN_RTOL (the same bits expected), every
                parameter after step 1 within 2 lr of the plain step's, the
                loss falling, phase 12's flash forward and backward
                launches per layer, all on wgmma_bf16 (the counts reset
                just before the sharded steps and read just after), both
                steps' ms and the sharded steps' peak memory; (b) on a
                (1, 1, 1) ("pod", "data", "model") mesh, 2 steps of
                ``make_train_step_dp_compressed(mesh=)`` beside phase 35's
                group form from the same init: step 1's loss the same bits,
                every parameter after step 1 within phase 35's bars; (c)
                rank 0 of a (1, 4) mesh of a fake process group: a train
                step at 9 of 36 heads a rank, its ms and its flash forward
                and backward launches at (1, 4096, 9, 64) (its outputs are
                not checked)
43. sharded moe  run right after phase 7, on phase 6's granite-moe
                (full width and depth, bf16, gather): (a) on a one-rank
                NCCL group and a (1, 1) mesh, under the ``ep`` ruleset
                and then ``base``, a prefill of 4 x 1000 tokens three times
                and MOE_MESH_DECODE greedy decode steps through the steps
                with ``mesh=``, beside the same steps without one: the
                same greedy tokens, the logits within SHARDED_LOGITS_BAR,
                moe_gmm's launches 32 layers x (3 + MOE_MESH_DECODE) and
                the flash kernel's 32 x 3, each on its bf16 route, none of
                the others (every count reset just before, read just
                after), prefill and decode ms both ways; then
                MOE_MESH_TRAIN_STEPS train steps of granite-moe at
                MOE_TRAIN_LAYERS layers (phase 12's recipe, gather,
                ``ep``) beside as many plain
                steps from the same init: step 1's loss, aux and
                grad_norm within TRAIN_RTOL, every parameter after step 1
                within 2 lr, each kernel's launches on its train route,
                the step ms both ways; (b) rank 0 of a (1, 4) mesh of fake
                ranks: granite-moe's prefill at 10 of 40 experts a rank
                (``ep``) and at d_ff 128 of 512 (``base``), and
                mixtral-8x7b's at all 32 layers under ``ep`` (2 of 8
                experts a rank, its weights drawn one layer at a time and
                placed as drawn): every kernel's launches over 3
                prefills (flash 3 x the layers at the rank's local heads,
                moe_gmm 3 x the layers, each on its bf16 route); moe_gmm's
                local shape and CUDA-event ms a launch beside its bound
                over the live rows, and its first call's own buckets,
                weights and fills through the kernel again against the
                plain version at GMM_RTOL; the prefill ms, mixtral's
                weights a rank and peak memory (the logits not checked)
44. sharded recurrent  the recurrent blocks on meshes under ``base``, each
                kernel's launches counted from 0 on each path and checked
                by route (flash on wgmma_bf16, rglru_scan on fused_bias,
                mlstm_scan on wgmma_bf16): run right after phase 9, on
                phase 8's recurrentgemma-9b (full width and depth, bf16),
                and right after phase 11, on phase 10's xlstm-1.3b cut to
                its first XLSTM_MESH_LAYERS = 4 layers (2 mLSTM, 2 sLSTM):
                (a), (c) on a one-rank NCCL group and a (1, 1) mesh, 3
                prefills of 4 x 1000 tokens and RECURRENT_MESH_DECODE
                decode steps fed the unsharded steps' greedy tokens,
                beside them: the logits within SHARDED_LOGITS_BAR, the
                greedy tokens that agree, one launch a recurrent or LOCAL
                layer in the prefill and none in decode, prefill and
                decode ms both ways, the mesh steps' peak memory; (d)
                rank 0 of a (1, 4) mesh of fake ranks: the prefill,
                every kernel's launches and the
                shapes it received (rglru_scan at (4, 1000, 1024), flash
                at 4 query heads over the one KV head, Dh 256; mlstm_scan
                at one head of Dh 1024), each kernel's first call there
                at its shapes, dtypes and parameters (its activations
                drawn anew: the fake ranks' collectives leave their
                outputs unwritten) through the kernel again against its
                plain version and timed beside its bound, the prefill's
                ms and peak memory
                (the logits not checked); then (b), after phase 11: on the
                (1, 1) mesh, a train step of recurrentgemma-9b at 6 layers
                (2 x 4096) and of xlstm-1.3b at 4 layers (2 x 256), phase
                12's recipe, beside a plain step from the same init: the
                loss and the grad norm within TRAIN_RTOL, every parameter
                after the step within 2 lr, each kernel's forward and backward
                launches on its train route
45. sharded vision and audio  under ``base``, each kernel's launches
                counted from 0 on each path and checked: run right after
                phase 18, on its llama-3.2-vision-11b (full width and
                depth, bf16, gates 0.5): (a) on a one-rank NCCL group and a
                (1, 1) mesh, 3 prefills of 4 x 1000 tokens with 1600
                patches a row (the CROSS layers' ck/cv sequence-sharded by
                ``cache_specs``, so that decode combines them) and
                VISION_MESH_DECODE greedy decode steps, beside the same
                steps without a mesh: the same greedy tokens, the logits
                within SHARDED_LOGITS_BAR, 32 flash launches a prefill, all
                causal on wgmma_bf16, none in decode, prefill and decode ms
                both ways; (b) rank 0 of a (1, 4) mesh of fake ranks: a
                prefill at 8 query heads over 2 KV heads a rank, the CROSS
                caches at 400 patches a rank, the weights a rank holds and
                the peak memory, the first flash call at its shapes against
                its plain version; then right after phase 21, on
                hubert-xlarge at full width and depth: (c) on a (1, 1)
                mesh, an encode of 1 x 4096 frames (bf16 weights) and
                AUDIO_MESH_TRAIN_STEPS train steps of phase 12's recipe,
                each beside the same without a mesh: the logits within
                SHARDED_LOGITS_BAR, step 1's loss and grad norm within
                TRAIN_RTOL, every parameter after step 1 within 2 lr, the
                flash forward and backward launches, none causal, on
                wgmma_bf16; (d) rank 0 of a (1, 4) mesh of fake ranks: a
                train step, the flash forward and backward at (1, 4096, 4,
                80) (padded to 120 in the kernel), the first call's forward
                and backward at its shapes against their plain versions

Earlier serve paths run at full depth, except where a note above says
otherwise; if the run outgrows its time, their depth is what gets cut
first.

It then prints one JSON line of kernel numbers, the card line, and as its
last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# The bound of a kernel (``launch.mesh.bound``) is the larger of its bytes
# over the card's memory rate and its FLOPs over the peak rate for its
# input type (the H100's published peaks, in ``launch.mesh``); each
# kernel's FLOPs and bytes come from its package's ``cost.work`` and
# ``cost.bwd_work``.
from repro_torch.kernels.flash_attention import cost as fa_cost  # noqa: E402
from repro_torch.kernels.mlstm_scan import cost as ml_cost  # noqa: E402
from repro_torch.kernels.moe_gmm import cost as gmm_cost  # noqa: E402
from repro_torch.kernels.rglru_scan import cost as rg_cost  # noqa: E402
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS, bound  # noqa: E402

# Tolerances of kernel against plain version, both on the same inputs and the
# plain version computing in float32 (inputs upcast):
#  * bf16: the kernel rounds its output to bf16, half a unit in the last
#    place of |o| < 8 is at most 2**-6 / 2 ~ 7.8e-3; 2e-2 leaves room for
#    outputs up to 8 and for float32 summation order.
#  * float32: both compute in float32 (no TF32) in another summation order
#    over at most S = 1000 keys; errors are ~1e-6, 1e-4 is the bar.
KERNEL_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

# moe_gmm against its plain version, relative to the plain version's
# max |y|, both on the same inputs and the plain version in float32:
#  * bf16: the kernel rounds h to bf16 before the down projection (as the
#    TPU kernel does) and y to bf16; each rounding is half a unit in the
#    last place, 2**-9 ~ 2e-3 of the value, so the error stays near 4e-3 of
#    max |y|; 2e-2 leaves 5x for float32 summation order.
#  * float32: both compute in float32 (no TF32) in another summation order
#    over at most d = 4096 and f = 14336 terms; errors are ~1e-6 of max |y|,
#    1e-4 is the bar.
GMM_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

# prefill + decode vs forward_logits in float32, relative to max |logit|:
# two summation orders over d = 2304 and 40 layers differ by ~1e-6 of the
# scale (6.6e-7 measured on an H100); a position off by one moves the
# logits by ~2e-3 of it, so the bar sits between the two, 20x from each.
CONSISTENCY_RTOL = 1e-4

# recurrentgemma-9b: the reference rounds the RG-LRU conv lag buffer to bf16
# in a float32 model too, and the port mirrors it, so its prefill + decode
# differs from forward_logits by that rounding.  At full width and depth on
# an H100 the gap is 9.0e-4 of the logits' scale and an off-by-one position
# gives 2.0e-2; the bar sits between the two, about 5x from each.
GRIFFIN_CONSISTENCY_RTOL = 4e-3

# xlstm-1.3b: both blocks round their conv lag buffers to bf16 in a float32
# model too (as the reference does), so prefill + decode differs from
# forward_logits by that rounding.  At full width and depth on an H100 the
# gap is 1.2e-3 of the logits' scale, and feeding each decode step the
# previous token (the control: xLSTM reads no position) gives 0.56; the bar,
# written before that run, sits 8x above the gap and 56x below the control.
XLSTM_CONSISTENCY_RTOL = 1e-2

# rglru_scan against its plain version, relative to the plain version's
# max |y|: both compute in float32 from the same inputs and the kernel does
# not round its output, for either input type; they differ by the last bits
# of exp / expm1 / sqrt and a fused multiply-add per step, which the
# recurrence (a < 1) does not amplify.
RGLRU_RTOL = 1e-5

# flash_attention's backward against its plain version (explicit formulas
# in float32 on the same q, k, v, o, dO), dq, dk and dv each relative to the
# plain gradient's max |.|:
#  * bf16: the kernel rounds P and dS to bf16 for the products that take
#    them, and dq, dk, dv on output (half a unit in the last place, 2**-9
#    ~ 2e-3 of the value, each), and reads the forward's bf16 o in D =
#    rowsum(dO o); 2e-2 leaves room for those roundings' sums.
#  * float32: both compute in float32 (no TF32) in another summation order
#    over at most 4096 keys or queries; errors are ~1e-6, 1e-4 is the bar.
# A gradient below 1e-3 of the largest of the three is a sum of cancelling
# terms of that size, so each scale is floored at 1e-3 of the largest.
# Where every query sees one key (S 1, or a window of 1), dP = D and dS = 0,
# so dq = dk = 0 in exact arithmetic and both sides hold only the rounding
# of dP and D in two summation orders (~3e-7 of the largest in float32):
# there dq and dk are held against the largest gradient's scale, which
# checks that they vanish.
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
BWD_SCALE_FLOOR = 1e-3
# the forward's row log-sum-exp against the plain one (natural log, ~log S
# plus the largest score, < 20 here): float32 sums of exact bf16 products
# or of float32 products in another order, ~1e-5 apart; 1e-4 is the bar
LSE_ATOL = 1e-4

# training consistency: the same float32 step (loss and every parameter's
# gradient) on the card (the flash kernel's scalar routes, cuBLAS) and on
# the CPU (the plain versions), from the same weights and batch, relative
# to each leaf's max |g| (floored at 1e-3 of the largest leaf's, as a leaf
# whose gradient nearly vanishes holds only rounding): other summation
# orders over d = 2304, 1024 keys and 122753 logits agree to ~1e-6; the
# labels shifted by one position move the gradients by O(1) of their
# scale, so 1e-4 sits between the two.
TRAIN_RTOL = 1e-4
TRAIN_FLOOR = 1e-3

# mlstm_scan against its plain version, relative to the plain version's max
# |h| (and max |C|, |n|, |m| for the state): both compute in float32 from the
# same inputs, in another order (chunks of 64 steps against the reference's
# 8 at S = 1000; sums over Dh = 1024 and up to 1000 steps); errors are
# ~1e-6 of the scale, 1e-4 is the bar.
MLSTM_RTOL = 1e-4

ARCH = "minicpm-2b"
MOE_ARCH = "granite-moe-3b-a800m"
GRIFFIN_ARCH = "recurrentgemma-9b"
XLSTM_ARCH = "xlstm-1.3b"
XLSTM_PROFILE_LEN = 200     # prompt tokens of the profiled xLSTM prefill
XLSTM_SERVE_LAYERS = 24     # its served depth, of 48
SERVE_REQUESTS, SERVE_SLOTS, PROMPT_LEN, GEN = 8, 4, 1000, 16
# training: minicpm-2b at full width and depth, the reference's train_4k
# sequence, a global batch of 2 as two microbatches of 1 (its global batch
# of 256 does not fit one card), 4 AdamW steps on one batch, then an eval
TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS = 4096, 2, 2, 4
TRAIN_LR, TRAIN_WARMUP = 3e-4, 1
# the consistency step: full width, depth cut to 2 layers, float32
CONSIST_LAYERS, CONSIST_SEQ = 2, 1024
# the recurrent families' training at full width, depth cut for time:
# recurrentgemma-9b to 2 periods of (RG-LRU, RG-LRU, LOCAL), 6 layers, at
# TRAIN_SEQ; xlstm-1.3b to 2 periods of (mLSTM, sLSTM), 4 layers, at S
# 1024 (the sLSTM's plain loop over time is ~60 launches a step and layer)
GRIFFIN_TRAIN_LAYERS = 6
XLSTM_TRAIN_LAYERS, XLSTM_TRAIN_SEQ = 4, 1024
# their float32 consistency steps: one period each, at S 512
GRIFFIN_CONSIST_LAYERS, XLSTM_CONSIST_LAYERS, RECURRENT_CONSIST_SEQ = \
    3, 2, 512
# the vision and audio paths: llama-3.2-vision-11b serves at full width
# and depth (8 requests of 1000 prompt tokens, n_patches patches of image
# memory a row); hubert-xlarge trains at full width and depth as the
# others do, and encodes ENCODE_BATCH rows of TRAIN_SEQ frames
VISION_ARCH = "llama-3.2-vision-11b"
AUDIO_ARCH = "hubert-xlarge"
ENCODE_BATCH = 4
# a CROSS layer's gate starts at 0 (its path then adds nothing) and every
# norm scale at 0: the vision phases set each gate to GATE, and the
# vision and train consistency phases draw each norm scale at 0.1 N(0, 1)
GATE = 0.5
# their float32 consistency checks: one period of the vision pattern (4
# ATTN, 1 CROSS) at S 512 (prefill + decode, card against CPU); hubert's
# training step at 2 layers, S 512
VISION_CONSIST_LAYERS, VISION_CONSIST_SEQ = 5, 512
AUDIO_CONSIST_LAYERS, AUDIO_CONSIST_SEQ = 2, 512
# the other four zoo configs, each served as phase 4 serves minicpm-2b:
# (arch, depth, MoE dispatch, prompt tokens; None for full depth and
# PROMPT_LEN).  h2o-danube-3-4b takes prompts of SWA_PROMPT_LEN tokens,
# past its window of 4096, so that prefill ring-rotates the cache and
# decode wraps it.  mixtral-8x7b's 32 layers are 87 GiB of bf16 weights,
# more than the card: 24 layers were 65.4 GiB; 16 since phase 44 came
# (43.6 GiB), for the call's time.  It serves through gather (einsum's
# groups do not divide every T)
SWA_PROMPT_LEN = 5000
MIXTRAL_SERVE_LAYERS = 16
ZOO_ARCHS = (("h2o-danube-3-4b", None, "einsum", SWA_PROMPT_LEN),
             ("minitron-8b", None, "einsum", None),
             ("deepseek-coder-33b", None, "einsum", None),
             ("mixtral-8x7b", MIXTRAL_SERVE_LAYERS, "gather", None))
# their float32 consistency: a model of ZOO_CONSIST_LAYERS layers at full
# width drawn anew (a float32 copy of deepseek-coder-33b would be 124 GiB),
# at B 2, S 200, or for the two windowed configs at B 1, SWA_CONSIST_SEQ
# past the window; then its forward_logits on the card against the CPU's
# at B 1, CPU_CHECK_SEQ
ZOO_CONSIST_LAYERS, SWA_CONSIST_SEQ, CPU_CHECK_SEQ = 2, 4200, 128
# phase 37: the auto mesh's cell is counted on a node of this many cards
AUTO_MESH_CHIPS = 8
# phase 41: caches of 1024 slots, so that cache_specs shards their sequence
# dim; on a one-rank mesh the sharded steps run the unsharded ops on the
# same whole tensors, so the bar only allows bf16 rounding in another order
SHARDED_CACHE_LEN, SHARDED_LOGITS_BAR, SHARDED_TP = 1024, 2e-2, 4
# ... on the first SHARDED_SERVE_LAYERS of phase 4's 40 layers (since
# phase 44 came: the whole depth took 30-42 s of the call)
SHARDED_SERVE_LAYERS = 10
# phase 43: granite-moe on a one-rank mesh decodes MOE_MESH_DECODE greedy
# steps (DTensor's host cost makes a step ~1 s there) and trains
# MOE_MESH_TRAIN_STEPS steps of MOE_TRAIN_LAYERS layers; then rank 0 of a
# (1, SHARDED_TP) mesh of fake ranks prefills granite-moe and mixtral-8x7b
# at all 32 layers
MOE_MESH_DECODE, MOE_MESH_TRAIN_STEPS = 4, 2
MIXTRAL_ARCH = "mixtral-8x7b"
# phase 44: recurrentgemma-9b (full depth) and xlstm-1.3b (its first
# XLSTM_MESH_LAYERS served layers) on a one-rank mesh: three prefills and
# RECURRENT_MESH_DECODE decode steps fed the unsharded steps' greedy
# tokens; one train step of each beside a plain one, xlstm-1.3b's at
# XLSTM_MESH_TRAIN_SEQ (its sLSTM loop made 2 steps at 1024 take 74 s)
RECURRENT_MESH_DECODE, RECURRENT_MESH_TRAIN_STEPS = 4, 1
XLSTM_MESH_LAYERS, XLSTM_MESH_TRAIN_SEQ = 4, 256
# phase 45: llama-3.2-vision-11b (phase 18's weights, full depth) on a
# one-rank mesh: three prefills of 4 x 1000 tokens with 1600 patches a row
# and VISION_MESH_DECODE greedy decode steps; hubert-xlarge at full depth
# there: an encode of 1 x TRAIN_SEQ frames and AUDIO_MESH_TRAIN_STEPS train
# steps, each beside the same without a mesh
VISION_MESH_DECODE, AUDIO_MESH_TRAIN_STEPS = 4, 2


_T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} [at {time.perf_counter() - _T0:.1f} s]", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters`` runs."""
    for _ in range(warmup):
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


# the port's kernels, by a part of their CUDA function names; a kernel
# counts under the first entry whose part it holds
PORT_KERNELS = (("flash_attention_bwd", "flash_bwd"),
                ("flash_attention", "flash_fwd"), ("moe_gmm_bwd", "gmm_bwd"),
                ("moe_gmm", "gmm_"),
                ("rglru_scan_bwd", "rglru_bwd"), ("rglru_scan", "rglru_scan"),
                ("mlstm_scan_bwd", "mlstm_bwd"), ("mlstm_scan", "mlstm_"))


def profile_ms(fn, host_ops: bool = True):
    """(wall ms, device-busy ms, top kernels, {port kernel: (ms, launches)})
    of one call, by torch.profiler.

    Device-busy is the sum of the kernels' device times; the profiler's own
    overhead inflates the wall time, so read the share, not the wall.
    ``host_ops=False`` records the device's activity only, which keeps a
    long multi-threaded call's trace small."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    port = {}
    for e in kernels:
        name = next((n for n, part in PORT_KERNELS if part in e.key), None)
        if name is not None:
            ms, n = port.get(name, (0.0, 0))
            port[name] = (ms + e.self_device_time_total / 1e3, n + e.count)
    return wall, busy, [(e.self_device_time_total / 1e3, e.count, e.key)
                        for e in top], port


def kernel_passes_ms(fn, pattern: str, calls: int = 10) -> dict:
    """{a CUDA kernel's name as ``pattern`` (a regular expression) matches
    it: mean device ms per call} over ``calls`` calls of ``fn``, by the
    profiler (empty if it saw none)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    passes = {}
    for e in prof.key_averages():
        found = re.search(pattern, e.key)
        if e.device_type == torch.autograd.DeviceType.CUDA and found and \
                e.count:
            name = found.group(0)
            passes[name] = passes.get(name, 0.0) + \
                e.self_device_time_total / calls / 1e3
    return passes


def print_profile(label, wall, busy, top, port):
    if busy <= 0:
        print(f"  profile {label}: device time not measured (the profiler "
              f"saw no kernels)", flush=True)
        return
    print(f"  profile {label}: wall {wall:.2f} ms under the profiler, device "
          f"busy {busy:.2f} ms ({busy / wall:.1%}); top kernels:", flush=True)
    for ms, n, name in top:
        print(f"    {ms:9.3f} ms {n:6d}x  {name[:90]}", flush=True)
    for name, (ms, n) in port.items():
        print(f"    port kernel {name}: {ms:.3f} ms over {n} launches, "
              f"{ms / busy:.1%} of device busy", flush=True)


def phase_device() -> str:
    phase("device")
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    # state the float32 matmul precision of every plain version: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build() -> None:
    from repro_torch.kernels import build
    phase("build")
    info = build.build()
    for line in info.log.splitlines():
        if any(w in line for w in ("registers", "spill", "Function properties",
                                   "Compiling entry", "wgmma", "setmaxnreg",
                                   "warning")):
            print("  " + line.strip())
    print(f"built {info.path.relative_to(ROOT)} in {info.seconds:.3f} s"
          f"{' (cached)' if info.cached else ''}", flush=True)
    from repro_torch.kernels.flash_attention import kernel, ops
    for dtype, (_, route) in kernel.ROUTES.items():
        print(f"  flash_attention {route} dynamic shared memory per block: "
              + ", ".join(f"Dh={dh}: {kernel.shared_memory_bytes(dh, dtype)} B"
                          for dh in ops.SUPPORTED_HEAD_DIMS), flush=True)
    for dtype, route in kernel.BWD_ROUTES.items():
        print(f"  flash_attention backward {route} (dK/dV and dQ passes) "
              f"dynamic shared memory per block: " + ", ".join(
                  f"Dh={dh}: {kernel.bwd_shared_memory_bytes(dh, dtype)} B"
                  for dh in ops.SUPPORTED_HEAD_DIMS), flush=True)
    from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
    B, S, H, Dh = MLSTM_CASES[0][1:5]
    for route in ml_kernel.ROUTES:
        sizes = []
        for dh in (32, 512, 1024, 1300):
            if route == "wgmma_bf16" and dh % 8:
                continue
            smem = ml_kernel.shared_memory_bytes(dh, route)
            where = ""
            if route != "wgmma_bf16":
                in_smem = ml_kernel.state_in_shared_memory(dh)
                where = f" (C in {'shared' if in_smem else 'device'} memory)"
            sizes.append(f"Dh={dh}: " + ", ".join(
                f"{k} {v} B" for k, v in smem.items()) + where)
        print(f"  mlstm_scan {route}: chunk {ml_kernel.chunk(route)}; "
              f"workspace at B={B} S={S} H={H} Dh={Dh} "
              f"{ml_kernel.workspace_bytes(B, S, H, Dh, route)} B; dynamic "
              f"shared memory per block: " + "; ".join(sizes), flush=True)
    B, S, H, Dh = MLSTM_BWD_CASES[0][1:5]
    for route in ml_kernel.BWD_ROUTES:
        print(f"  mlstm_scan backward {route}: chunk "
              f"{ml_kernel.bwd_chunk(route)}; workspace at B={B} S={S} H={H} "
              f"Dh={Dh} {ml_kernel.bwd_workspace_bytes(B, S, H, Dh, route)} "
              f"B", flush=True)


# (name, B, S, H, KH, Dh, causal, window); the cases in TIMED_CASES are
# serving shapes, timed in bf16
KERNEL_CASES = [
    ("minicpm-prefill", 4, 1000, 36, 36, 64, True, 0),
    ("granite-prefill", 4, 1000, 24, 8, 64, True, 0),
    ("griffin-prefill", 4, 1000, 16, 1, 256, True, 2048),
    ("griffin-window", 1, 2304, 16, 1, 256, True, 2048),
    ("h2o-danube-swa", 2, 1000, 32, 8, 120, True, 256),
    ("single-token", 2, 1, 8, 2, 128, True, 0),
    ("ragged-136", 2, 136, 8, 2, 128, True, 0),
    ("ragged-136-window", 2, 136, 8, 2, 64, True, 100),
    ("non-causal-136", 2, 136, 4, 4, 120, False, 0),
    ("vision-prefill", 4, 1000, 32, 8, 128, True, 0),
    ("hubert-train", 1, TRAIN_SEQ, 16, 16, 80, False, 0),
    # deepseek-coder-33b's prefill: a GQA group of 7 (56 over 8 heads)
    ("deepseek-prefill", 4, 1000, 56, 8, 128, True, 0),
    # h2o-danube-3-4b's prefill past its window of 4096, at head dim 120
    ("h2o-long-prefill", 4, SWA_PROMPT_LEN, 32, 8, 120, True, 4096),
    # minicpm-2b's prefill on one rank of a (1, SHARDED_TP) mesh (phase 41)
    ("minicpm-rank-prefill", 4, 1000, 36 // SHARDED_TP, 36 // SHARDED_TP,
     64, True, 0),
    # minicpm-2b's train shape, one microbatch (phase 12 launches the
    # forward 160 times a step)
    ("minicpm-train", 1, TRAIN_SEQ, 36, 36, 64, True, 0),
]
TIMED_CASES = ("minicpm-prefill", "granite-prefill", "griffin-prefill",
               "vision-prefill", "hubert-train", "deepseek-prefill",
               "h2o-long-prefill", "minicpm-rank-prefill", "minicpm-train")


def phase_kernel():
    """Returns {timed case name: timing} of the flash kernel."""
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    phase("kernel")
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    for name, B, S, H, KH, Dh, causal, window in KERNEL_CASES:
        q32 = torch.randn((B, S, H, Dh), generator=gen, device="cuda")
        k32 = torch.randn((B, S, KH, Dh), generator=gen, device="cuda")
        v32 = torch.randn((B, S, KH, Dh), generator=gen, device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            route = kernel.ROUTES[dtype][1]
            before = kernel.LAUNCHES_BY_ROUTE[route]
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            check(kernel.LAUNCHES_BY_ROUTE[route] == before + 1,
                  f"flash_attention {name} {dtype} did not run on {route}")
            want = ref.reference_attention(q.float(), k.float(), v.float(),
                                           causal=causal, window=window)
            err = float((out.float() - want).abs().max())
            tol = KERNEL_TOL[dtype]
            print(f"  {name:18s} {str(dtype):15s} B={B} S={S} H={H} KH={KH} "
                  f"Dh={Dh} causal={causal} window={window} ({route}): "
                  f"max_abs_err={err:.3e} tol={tol:.0e}", flush=True)
            check(math.isfinite(err) and err <= tol,
                  f"flash_attention {name} {dtype}: error {err} > {tol}")
            if name in TIMED_CASES and dtype == torch.bfloat16:
                result[name] = time_kernel(q, k, v, causal, window, err)
    return result


def pad_head_dim(*ts):
    """The tensors zero-padded along Dh to the kernel's head dim, as the
    wrapper pads them (``ops.kernel_head_dim``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    dh = ops.kernel_head_dim(ts[0].shape[3])
    return tuple(F.pad(t, (0, dh - t.shape[3])).contiguous() for t in ts)


def sdpa_ms(q, k, v, causal: bool, window: int):
    """One PyTorch call computing flash's function on (B, S, H, Dh) q, k,
    v, timed: a yardstick only, which the port never calls.  Where the
    window bites, is_causal alone would attend beyond it, so SDPA gets the
    band as a boolean mask (masked SDPA, on another backend), as in
    ``sdpa_bwd_call``.  Returns (ms, the call's name)."""
    import torch.nn.functional as F
    S, H, KH = q.shape[1], q.shape[2], k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if 0 < window < S:
        band = band_mask(S, window, causal, q.device)
        return cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band, enable_gqa=H != KH),
            iters=5), "masked sdpa"
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=H != KH)), "sdpa"


def time_kernel(q, k, v, causal, window, err):
    """Kernel (through the wrapper, as the model calls it), plain version
    and library times at a model's shape; at a head dim the wrapper pads,
    also the kernel alone on inputs padded beforehand."""
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    B, S, H, Dh = q.shape
    KH = k.shape[2]
    kernel_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                    window=window))
    padded = {}
    if Dh not in ops.SUPPORTED_HEAD_DIMS:
        qp, kp, vp = pad_head_dim(q, k, v)
        out = torch.empty_like(qp)
        padded["padded_kernel_ms"] = cuda_ms(lambda: kernel.launch(
            qp, kp, vp, out, causal=causal, window=window,
            scale=1.0 / math.sqrt(Dh)))
        del qp, kp, vp, out
    plain_ms = cuda_ms(lambda: ref.reference_attention(
        q, k, v, causal=causal, window=window), iters=5)
    library_ms, sdpa_name = sdpa_ms(q, k, v, causal, window)
    bound_ms, bound_by, flops, nbytes = bound(fa_cost.work(
        B, S, H, KH, Dh, causal, window, q.dtype), q.dtype)
    print(f"  timing at B={B} S={S} H={H} KH={KH} Dh={Dh} window={window} "
          f"{q.dtype}: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, {sdpa_name} "
          f"{library_ms:.4f} ms, kernel / {sdpa_name} "
          f"{kernel_ms / library_ms:.2f}x; "
          f"bound {bound_ms * 1e3:.2f} us by {bound_by} "
          f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)"
          + (f"; the kernel alone on inputs padded to Dh "
             f"{ops.kernel_head_dim(Dh)}: {padded['padded_kernel_ms']:.4f} "
             f"ms" if padded else ""), flush=True)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": sdpa_name,
            "bound_ms": bound_ms, "bound_by": bound_by, **padded}


# (name, B, S, H, KH, Dh, causal, window): the train phases' own shapes
# (minicpm-2b and recurrentgemma-9b's LOCAL attention, one microbatch of
# 4096); MHA, GQA 24/8 and MQA; causal, not causal and windows that bite;
# head dims 16 and 80 padded by the wrapper; S 1, 63, 65, 1000 and 4096.
# BWD_TIMED_CASES are timed in bf16: minicpm's train shape for the kernels
# line's numbers, the others under its at_* keys.
BWD_CASES = [
    ("minicpm-train", 1, TRAIN_SEQ, 36, 36, 64, True, 0),
    ("griffin-train", 1, TRAIN_SEQ, 16, 1, 256, True, 2048),
    ("minicpm-prefill", 4, 1000, 36, 36, 64, True, 0),
    ("granite-prefill", 4, 1000, 24, 8, 64, True, 0),
    ("griffin-prefill", 4, 1000, 16, 1, 256, True, 2048),
    ("window-bites-1000", 2, 1000, 8, 2, 128, True, 100),
    ("single-token", 2, 1, 8, 2, 64, True, 0),
    ("ragged-63", 2, 63, 8, 8, 120, True, 0),
    ("ragged-65-mqa-window", 2, 65, 6, 1, 256, True, 32),
    ("dh16-padded", 2, 65, 4, 2, 16, True, 0),
    ("dh80-non-causal", 2, 63, 4, 4, 80, False, 0),
    ("non-causal-window", 1, 200, 4, 2, 64, False, 40),
    ("hubert-train", 1, TRAIN_SEQ, 16, 16, 80, False, 0),
    # minicpm-2b's train shape on one rank of a (1, SHARDED_TP) mesh
    # (phase 42 (c))
    ("minicpm-rank-train", 1, TRAIN_SEQ, 36 // SHARDED_TP, 36 // SHARDED_TP,
     64, True, 0),
]
BWD_TIMED_CASES = ("minicpm-train", "griffin-train", "minicpm-prefill",
                   "granite-prefill", "griffin-prefill", "hubert-train",
                   "minicpm-rank-train")
# the backward's route by dtype, as the port's kernel.BWD_ROUTES must say
BWD_EXPECTED_ROUTES = {torch.bfloat16: "wgmma_bf16",
                       torch.float32: "scalar_f32"}


def bwd_errors(got, want, one_key):
    """(each of dq, dk, dv's max error over the plain gradient's max |.|,
    floored at BWD_SCALE_FLOOR of the largest of the three; the largest
    absolute error).  With ``one_key`` (every query sees one key), dq and
    dk vanish in exact arithmetic and are held against the largest scale."""
    scales = [float(w.abs().max()) for w in want]
    floor = BWD_SCALE_FLOOR * max(scales)
    if one_key:
        scales[0] = scales[1] = max(scales)
    errs = [float((g.float() - w).abs().max()) for g, w in zip(got, want)]
    return [e / max(sc, floor) for e, sc in zip(errs, scales)], max(errs)


def phase_kernel_bwd():
    """The flash backward against its plain version, and in bf16 against
    itself on a second call (bit for bit); returns the timing at minicpm's
    train shape, with recurrentgemma's and hubert-xlarge's train shapes and
    minicpm's, granite's and recurrentgemma's prefill shapes and minicpm's
    train shape on one rank of phase 42's (1, SHARDED_TP) mesh under
    at_griffin_train_shape, at_hubert_train_shape,
    at_minicpm_prefill_shape, at_granite_shape, at_griffin_shape and
    at_minicpm_rank_train_shape."""
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    phase("kernel_bwd")
    gen = torch.Generator(device="cuda").manual_seed(1)
    result = {}
    for name, B, S, H, KH, Dh, causal, window in BWD_CASES:
        q32, k32, v32, do32 = (
            torch.randn((B, S, h, Dh), generator=gen, device="cuda")
            for h in (H, KH, KH, H))
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dtype).requires_grad_() for t in (q32, k32, v32))
            do = do32.to(dtype)
            route = kernel.BWD_ROUTES[dtype]
            check(route == BWD_EXPECTED_ROUTES[dtype],
                  f"flash backward's {dtype} route is {route}, not "
                  f"{BWD_EXPECTED_ROUTES[dtype]}")
            fwd_route = kernel.ROUTES[dtype][1]
            before = (kernel.BWD_LAUNCHES_BY_ROUTE[route],
                      kernel.LAUNCHES_BY_ROUTE[fwd_route])
            o = ops.flash_attention(q, k, v, causal=causal, window=window)
            bf16 = dtype == torch.bfloat16
            grads = torch.autograd.grad(o, (q, k, v), do, retain_graph=bf16)
            torch.cuda.synchronize()
            check((kernel.BWD_LAUNCHES_BY_ROUTE[route],
                   kernel.LAUNCHES_BY_ROUTE[fwd_route]) ==
                  (before[0] + 1, before[1] + 1),
                  f"flash backward {name} {dtype} did not run on {route} "
                  f"after a forward on {fwd_route}")
            same_note = ""
            if bf16:
                # deterministic: no atomics, every sum in a fixed order
                again = torch.autograd.grad(o, (q, k, v), do)
                same = all(torch.equal(a, b) for a, b in zip(grads, again))
                check(same, f"flash backward {name} {dtype}: a second call "
                            f"gave other bits")
                same_note = ", repeat bit-identical"
                del again
            qd, kd, vd = (t.detach() for t in (q, k, v))
            lse = ref.reference_attention_lse(qd, kd, causal=causal,
                                              window=window)
            want = ref.reference_attention_bwd(qd, kd, vd, o.detach(), lse,
                                               do, causal=causal,
                                               window=window)
            errs, abs_err = bwd_errors(grads, want, S == 1 or window == 1)
            del want
            tol = BWD_TOL[dtype]
            lse_note = ""
            if Dh in ops.SUPPORTED_HEAD_DIMS:
                # the log-sum-exp the training forward writes
                out = torch.empty_like(qd)
                klse = torch.empty((B, H, S), device="cuda")
                kernel.launch(qd, kd, vd, out, causal=causal, window=window,
                              lse=klse)
                torch.cuda.synchronize()
                lse_err = float((klse - lse).abs().max())
                lse_note = f", lse max_abs_err={lse_err:.3e}"
                check(lse_err <= LSE_ATOL,
                      f"flash forward {name} {dtype}: lse error {lse_err}")
            print(f"  {name:20s} {str(dtype):15s} B={B} S={S} H={H} KH={KH} "
                  f"Dh={Dh} causal={causal} window={window} ({route}): rel "
                  f"err dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
                  f"tol={tol:.0e}{lse_note}{same_note}", flush=True)
            check(all(math.isfinite(e) and e <= tol for e in errs),
                  f"flash backward {name} {dtype}: errors {errs} > {tol}")
            if name in BWD_TIMED_CASES and dtype == torch.bfloat16:
                result[name] = time_kernel_bwd(qd, kd, vd, do, causal,
                                               window, abs_err)
            del q, k, v, o, grads
    torch.cuda.empty_cache()
    timing = dict(result["minicpm-train"])
    timing["at_griffin_train_shape"] = result["griffin-train"]
    timing["at_hubert_train_shape"] = result["hubert-train"]
    timing["at_minicpm_prefill_shape"] = result["minicpm-prefill"]
    timing["at_granite_shape"] = result["granite-prefill"]
    timing["at_griffin_shape"] = result["griffin-prefill"]
    timing["at_minicpm_rank_train_shape"] = result["minicpm-rank-train"]
    return timing


def band_mask(S, window, causal, device):
    """(S, S) bool: True where query i may see key j under the window (and
    the causal mask), for SDPA's ``attn_mask``."""
    pos = torch.arange(S, device=device)
    dist = pos[:, None] - pos[None, :]
    band = dist < window
    if causal:
        band &= dist >= 0
    return band


def sdpa_bwd_call(q, k, v, do, causal, window):
    """(a call of ``torch.autograd.grad`` of SDPA on (B, S, heads, Dh) q,
    k, v and dO, whether it takes an explicit mask): a yardstick only, the
    port never calls it.  Where the window bites (some query is at least
    ``window`` past a key it could otherwise see), ``is_causal`` alone
    would attend beyond it, so SDPA gets the band as a boolean mask and
    computes the same function (masked SDPA, on another backend)."""
    import torch.nn.functional as F
    B, S, H, _ = q.shape
    KH = k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    masked = 0 < window < S
    if masked:
        ot = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band_mask(S, window, causal, q.device),
            enable_gqa=H != KH)
    else:
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                            enable_gqa=H != KH)
    dot = do.transpose(1, 2).contiguous()
    return (lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                        retain_graph=True)), masked


def time_kernel_bwd(q, k, v, do, causal, window, err):
    """The backward kernel's passes, its plain version and
    ``torch.autograd.grad`` of SDPA (``sdpa_bwd_call``) on the same
    inputs.  At a head dim the wrapper pads, the kernel runs on inputs
    padded beforehand (as the autograd function receives them)."""
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    B, S, H, Dh = q.shape
    KH = k.shape[2]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    scale = 1.0 / math.sqrt(Dh)
    kdh = ops.kernel_head_dim(Dh)
    qp, kp, vp, dop = (q, k, v, do) if kdh == Dh else \
        pad_head_dim(q, k, v, do)
    out, lse = torch.empty_like(qp), torch.empty((B, H, S), device="cuda")
    kernel.launch(qp, kp, vp, out, causal=causal, window=window, scale=scale,
                  lse=lse)
    dq, dk, dv = (torch.empty_like(t) for t in (qp, kp, vp))
    dsum = torch.empty_like(lse)
    kernel_ms = cuda_ms(lambda: kernel.launch_bwd(
        qp, kp, vp, out, dop, lse, dsum, dq, dk, dv, causal=causal,
        window=window, scale=scale), iters=10)
    del qp, kp, vp, dop, dq, dk, dv
    out = out[..., :Dh]
    plain_ms = cuda_ms(lambda: ref.reference_attention_bwd(
        q, k, v, out, lse, do, causal=causal, window=window), iters=3,
        warmup=1)
    sdpa, masked = sdpa_bwd_call(q, k, v, do, causal, window)
    library_ms = cuda_ms(sdpa, iters=10)
    del sdpa
    sdpa_name = "masked sdpa" if masked else "sdpa"
    bound_ms, bound_by, flops, nbytes = bound(fa_cost.bwd_work(
        B, S, H, KH, Dh, causal, window, q.dtype), q.dtype)
    print(f"  backward timing at B={B} S={S} H={H} KH={KH} Dh={Dh} "
          f"(kernel Dh {kdh}) window={window} {q.dtype} (splits "
          f"{kernel.bwd_splits(B, S, H, KH, kdh, sms)}): kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, {sdpa_name} "
          f"backward {library_ms:.4f} ms, kernel / {sdpa_name} "
          f"{kernel_ms / library_ms:.2f}x; bound {bound_ms:.4f} ms by "
          f"{bound_by} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), "
          f"kernel / bound {kernel_ms / bound_ms:.2f}x", flush=True)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library": sdpa_name}


# (name, E, C, d, f, act, gated, pad): the last ``pad`` rows of each bucket
# are zero, as pad rows are in the served buckets.  The first case is the
# serving (prefill) shape, timed with every row real.
GMM_CASES = [
    ("granite-prefill", 40, 1000, 1536, 512, "swiglu", True, 0),
    ("granite-decode", 40, 8, 1536, 512, "swiglu", True, 7),
    ("mixtral-prefill", 8, 1250, 4096, 14336, "swiglu", True, 100),
    ("ragged-1", 4, 1, 256, 512, "swiglu", True, 0),
    ("ragged-136", 4, 136, 256, 512, "swiglu", True, 17),
    ("odd-d-f", 3, 100, 211, 333, "swiglu", True, 9),
    ("geglu-136", 4, 136, 256, 512, "geglu", True, 17),
    ("relu2-no-w3", 4, 136, 256, 512, "relu2", False, 17),
]
# (name, E, top k, T, C, d, f): a decode step's buckets with served
# routing, T tokens routed top-k of E experts by a seeded router, the
# buckets (C 8, the least capacity) filled to each expert's count and zero
# after, the fills handed to the kernel as ``counts``: granite-moe's, and
# mixtral-8x7b's (every touched expert's 3 x 4096 x 14336 weights read)
GMM_DECODE_ROUTED = ("granite-decode-routed", 40, 8, 4, 8, 1536, 512)
GMM_MIXTRAL_DECODE_ROUTED = ("mixtral-decode-routed", 8, 2, 4, 8, 4096,
                             14336)


def gmm_route(dtype, d, f) -> str:
    """The route of moe_gmm a contiguous fresh input takes (ops.py's rule):
    float32 on the scalar kernels, bf16 on wgmma where TMA can address it
    (d and f multiples of 8), else on the WMMA kernels."""
    if dtype == torch.float32:
        return "scalar_f32"
    return "wgmma_bf16" if d % 8 == 0 and f % 8 == 0 else "wmma_bf16"


def run_gmm_case(name, xe, p, act, counts, pad_note):
    """One moe_gmm call on the route its inputs pick, held against the
    plain version; returns (max abs error, rows at or past counts all 0)."""
    from repro_torch.kernels.moe_gmm import kernel, ops, ref
    E, C, d = xe.shape
    f = p["w1"].shape[-1]
    route = gmm_route(xe.dtype, d, f)
    got_route = ops.kernel_route(xe, p["w1"], p.get("w3"), p["w2"])
    check(got_route == route,
          f"moe_gmm {name}: route {got_route}, expected {route}")
    before = kernel.LAUNCHES_BY_ROUTE[route]
    out = ops.expert_ffn(xe, p, act, counts)
    torch.cuda.synchronize()
    check(kernel.LAUNCHES_BY_ROUTE[route] == before + 1,
          f"moe_gmm {name} {xe.dtype} did not run on {route}")
    want = ref.reference_expert_ffn(
        xe.float(), {k: w.float() for k, w in p.items()}, act, counts)
    scale = float(want.abs().max())
    err = float((out.float() - want).abs().max())
    rel = err / scale if scale > 0 else err
    tol = GMM_RTOL[xe.dtype]
    pads_zero = True
    if counts is not None:
        rows = torch.arange(C, device=xe.device)
        pads_zero = not bool(out[rows[None, :] >= counts[:, None]].any())
    print(f"  {name:21s} {str(xe.dtype):15s} E={E} C={C} d={d} f={f} "
          f"{act}{'' if 'w3' in p else ' no w3'} ({route}): "
          f"max_abs_err={err:.3e} max|y|={scale:.3e} rel={rel:.3e} "
          f"tol={tol:.0e}; {pad_note}", flush=True)
    check(math.isfinite(rel) and rel <= tol,
          f"moe_gmm {name} {xe.dtype}: relative error {rel} > {tol}")
    check(pads_zero, f"moe_gmm {name} {xe.dtype}: a row past counts is not 0")
    return err


def phase_kernel_moe():
    """Returns the timings at the prefill and the routed decode shape."""
    from repro_torch.kernels.moe_gmm import kernel
    phase("kernel moe_gmm")
    gen = torch.Generator(device="cuda").manual_seed(1)
    result = None
    for name, E, C, d, f, act, gated, pad in GMM_CASES:
        x32 = torch.randn((E, C, d), generator=gen, device="cuda")
        x32[:, C - pad:] = 0.0
        p32 = {"w1": torch.randn((E, d, f), generator=gen, device="cuda")
               / math.sqrt(d),
               "w2": torch.randn((E, f, d), generator=gen, device="cuda")
               / math.sqrt(f)}
        if gated:
            p32["w3"] = torch.randn((E, d, f), generator=gen,
                                    device="cuda") / math.sqrt(d)
        for dtype in (torch.bfloat16, torch.float32):
            xe = x32.to(dtype)
            p = {k: w.to(dtype) for k, w in p32.items()}
            bound_ms, bound_by, _, _ = bound(gmm_cost.work(
                E, C - pad, d, f, gated, dtype), dtype)
            err = run_gmm_case(
                name, xe, p, act, None,
                f"bound over the {C - pad} real rows {bound_ms * 1e3:.2f} "
                f"us by {bound_by}")
            if result is None and dtype == torch.bfloat16:
                result = time_moe_kernel(xe, p, act, err)
            del xe, p
        del x32, p32
        torch.cuda.empty_cache()
    result["at_decode_routed"] = phase_kernel_moe_decode(
        gen, GMM_DECODE_ROUTED)
    result["at_mixtral_decode_routed"] = phase_kernel_moe_decode(
        gen, GMM_MIXTRAL_DECODE_ROUTED)
    print(f"  moe_gmm launches by route in this phase: "
          f"{dict(kernel.LAUNCHES_BY_ROUTE)}", flush=True)
    return result


def routed_fills(E, T, k, gen):
    """Bucket fills of a seeded top-k routing of T tokens over E experts:
    int32 (E,), and the number of experts some token reached."""
    logits = torch.randn((T, E), generator=gen, device="cuda")
    idx = torch.topk(logits, k, dim=-1).indices.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int32, device="cuda")
    counts.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return counts, int((counts > 0).sum())


def live_rows_bound(n_live, touched, d, f, dtype):
    """``bound`` of the least work of a gated expert FFN over ``n_live``
    live rows in ``touched`` experts: their weights, the live rows of xe
    read and of y written."""
    elem = torch.tensor([], dtype=dtype).element_size()
    return bound((6.0 * n_live * d * f,
                  elem * (2 * n_live * d + 3 * touched * d * f)), dtype)


def phase_kernel_moe_decode(gen, case):
    """A routed decode case (as GMM_DECODE_ROUTED) in bf16 and float32
    against the plain version, and the bf16 kernel's and plain version's
    times there beside two bounds: every expert's weights, and the touched
    experts' only."""
    from repro_torch.kernels.moe_gmm import ops, ref
    name, E, k, T, C, d, f = case
    counts, touched = routed_fills(E, T, k, gen)
    rows = torch.arange(C, device="cuda")
    live = (rows[None, :] < counts[:, None])[..., None]
    x32 = torch.randn((E, C, d), generator=gen, device="cuda") * live
    p32 = {n: torch.randn(s, generator=gen, device="cuda") / math.sqrt(s[1])
           for n, s in (("w1", (E, d, f)), ("w3", (E, d, f)),
                        ("w2", (E, f, d)))}
    n_live = int(counts.sum())
    result = None
    for dtype in (torch.bfloat16, torch.float32):
        xe = x32.to(dtype)
        p = {n: w.to(dtype) for n, w in p32.items()}
        err = run_gmm_case(name, xe, p, "swiglu", counts,
                           f"{n_live} live rows in {touched} of {E} experts")
        if dtype == torch.bfloat16:
            kernel_ms = cuda_ms(lambda: ops.expert_ffn(xe, p, "swiglu",
                                                       counts), iters=50)
            plain_ms = cuda_ms(lambda: ref.reference_expert_ffn(
                xe, p, "swiglu", counts), iters=10)
            all_ms, all_by, _, _ = bound(gmm_cost.work(E, C, d, f, True,
                                                        dtype), dtype)
            bound_ms, bound_by, _, nbytes = live_rows_bound(
                n_live, touched, d, f, dtype)
            print(f"  timing at {name} (E={E} C={C} d={d} f={f} {dtype}, "
                  f"{n_live} live rows, {touched} experts touched): kernel "
                  f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms; bound over "
                  f"the touched experts {bound_ms * 1e3:.2f} us by "
                  f"{bound_by} ({nbytes / 1e6:.2f} MB), over all {E} "
                  f"experts {all_ms * 1e3:.2f} us by {all_by}", flush=True)
            result = {"max_abs_err": err, "ms": kernel_ms,
                      "plain_ms": plain_ms, "library_ms": None,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "bound_all_experts_ms": all_ms,
                      "touched_experts": touched, "live_rows": n_live}
        del xe, p
    del x32, p32
    torch.cuda.empty_cache()
    return result


def time_moe_kernel(xe, p, act, err):
    """Kernel, plain version and bmm-yardstick times at the serving shape."""
    from repro_torch.kernels.moe_gmm import ops, ref
    from repro_torch.models.layers import act_fn
    E, C, d = xe.shape
    f = p["w1"].shape[-1]
    kernel_ms = cuda_ms(lambda: ops.expert_ffn(xe, p, act))
    plain_ms = cuda_ms(lambda: ref.reference_expert_ffn(xe, p, act), iters=5)
    # yardstick only: no single PyTorch call computes this function, and the
    # port's forward never calls bmm for the expert products
    fn = act_fn(act)
    yard_ms = cuda_ms(lambda: torch.bmm(
        fn(torch.bmm(xe, p["w1"])) * torch.bmm(xe, p["w3"]), p["w2"]))
    bound_ms, bound_by, flops, nbytes = bound(
        gmm_cost.work(E, C, d, f, True, xe.dtype), xe.dtype)
    print(f"  timing at E={E} C={C} d={d} f={f} {xe.dtype}: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, yardstick (3 bmm + "
          f"act, not a port) {yard_ms:.4f} ms; bound {bound_ms * 1e3:.2f} us "
          f"by {bound_by} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)",
          flush=True)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": None, "bmm_yardstick_ms": yard_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


# (name, B, S, D, x dtype, gate dtype, with h0, route).  The first two are
# the serving shape, timed (RGLRU_TIMED): on the fused route, as the bf16
# model hands its gates over (bf16 x, bf16 gate products and float32
# biases), and on whole float32 gates.  The kernel walks S in windows of
# 64 steps, 64 channels a block; D not a multiple of 8 stages with plain
# loads.
RGLRU_CASES = [
    ("griffin-prefill", 4, 1000, 4096, torch.bfloat16, torch.bfloat16,
     False, "fused_bias"),
    ("griffin-gates-f32", 4, 1000, 4096, torch.bfloat16, torch.float32,
     False, "gates"),
    ("griffin-prefill-f32", 4, 1000, 4096, torch.float32, torch.float32,
     False, "gates"),
    ("ragged-136", 2, 136, 128, torch.bfloat16, torch.float32, False,
     "gates"),
    ("d-640", 2, 128, 640, torch.bfloat16, torch.float32, False, "gates"),
    ("b-12", 12, 64, 128, torch.float32, torch.float32, False, "gates"),
    ("single-step", 3, 1, 256, torch.bfloat16, torch.float32, False,
     "gates"),
    ("odd-d", 3, 77, 200, torch.float32, torch.float32, False, "gates"),
    ("with-h0", 3, 77, 200, torch.bfloat16, torch.float32, True, "gates"),
    ("bf16-gates", 2, 136, 128, torch.bfloat16, torch.bfloat16, True,
     "gates"),
    ("fused-single-step", 1, 1, 96, torch.bfloat16, torch.bfloat16, True,
     "fused_bias"),
    ("fused-window-63", 3, 63, 77, torch.bfloat16, torch.bfloat16, False,
     "fused_bias"),
    ("fused-window-65", 12, 65, 200, torch.bfloat16, torch.bfloat16, True,
     "fused_bias"),
    ("fused-f32-129", 1, 129, 4100, torch.float32, torch.float32, True,
     "fused_bias"),
]
RGLRU_TIMED = ("griffin-prefill", "griffin-gates-f32")

# Long memory: a between 0.999 and 0.9999 at zero gate, from h0, on the
# fused route in bf16.  The plain version rounds each a, and over
# thousands of steps of a near 1 drifts from the recurrence in float64 by
# ~1e-5 of max |y| (1.1e-5 on an H100 at S 1000), so the kernel is held
# against float64 there: at most twice the plain version's own error and
# at most RGLRU_RTOL (the bar written before the first run on the card).
RGLRU_ORACLE_CASES = [("long-memory-1000", 2, 1000, 512),
                      ("long-memory-4096", 2, 4096, 512)]


def rglru_inputs(B, S, D, x_dt, g_dt, gen, u=(0.9, 0.999)):
    """(x, lam, ga, gx, h0, b_a, b_i) on the card; a in [u0, u1] at zero
    gate."""
    from repro_torch.kernels.rglru_scan.ref import RGLRU_C
    u = u[0] + (u[1] - u[0]) * torch.rand((D,), generator=gen, device="cuda")
    lam = torch.log(torch.expm1(-torch.log(u) / RGLRU_C))
    x, ga, gx = (torch.randn((B, S, D), generator=gen, device="cuda")
                 for _ in range(3))
    h0 = torch.randn((B, D), generator=gen, device="cuda")
    b_a, b_i = (0.5 * torch.randn((D,), generator=gen, device="cuda")
                for _ in range(2))
    return x.to(x_dt), lam, ga.to(g_dt), gx.to(g_dt), h0, b_a, b_i


def phase_kernel_rglru():
    from repro_torch.kernels.rglru_scan import kernel, ops, ref
    phase("kernel rglru_scan")
    gen = torch.Generator(device="cuda").manual_seed(2)
    timed = {}
    for name, B, S, D, x_dt, g_dt, with_h0, route in RGLRU_CASES:
        x, lam, ga, gx, h0, b_a, b_i = rglru_inputs(B, S, D, x_dt, g_dt, gen)
        h0 = h0 if with_h0 else None
        bias = dict(b_a=b_a, b_i=b_i) if route == "fused_bias" else {}
        before = kernel.LAUNCHES_BY_ROUTE[route]
        y, h = ops.rglru(x, lam, ga, gx, h0, **bias)
        torch.cuda.synchronize()
        check(kernel.LAUNCHES_BY_ROUTE[route] == before + 1,
              f"rglru_scan {name} did not run on {route}")
        # the plain version computes in float32 from the same inputs
        wy, wh = ref.reference_rglru(x, lam, ga, gx, h0, **bias)
        scale = float(wy.abs().max())
        err = max(float((y - wy).abs().max()), float((h - wh).abs().max()))
        rel = err / scale if scale > 0 else err
        bound_ms, bound_by, _, _ = bound(rg_cost.work(
            B, S, D, x_dt, g_dt, with_h0, bool(bias)), torch.float32)
        print(f"  {name:19s} x {str(x_dt):14s} gates {str(g_dt):14s} "
              f"B={B} S={S} D={D} h0={with_h0} ({route}): "
              f"max_abs_err={err:.3e} max|y|={scale:.3e} rel={rel:.3e} "
              f"tol={RGLRU_RTOL:.0e}; bound {bound_ms * 1e3:.2f} us by "
              f"{bound_by}", flush=True)
        check(math.isfinite(rel) and rel <= RGLRU_RTOL,
              f"rglru_scan {name}: relative error {rel} > {RGLRU_RTOL}")
        if name in RGLRU_TIMED:
            timed[route] = time_rglru_kernel(x, lam, ga, gx, bias, route,
                                             err)
        del x, ga, gx, y, wy
    for name, B, S, D in RGLRU_ORACLE_CASES:
        x, lam, ga, gx, h0, b_a, b_i = rglru_inputs(
            B, S, D, torch.bfloat16, torch.bfloat16, gen, u=(0.999, 0.9999))
        truth = ref.oracle_rglru(x, lam, ga, gx, h0, b_a=b_a, b_i=b_i)
        y, _ = ops.rglru(x, lam, ga, gx, h0, b_a=b_a, b_i=b_i)
        wy, _ = ref.reference_rglru(x, lam, ga, gx, h0, b_a=b_a, b_i=b_i)
        scale = float(truth.abs().max())
        err = float((y.double() - truth).abs().max()) / scale
        plain_err = float((wy.double() - truth).abs().max()) / scale
        print(f"  {name:19s} B={B} S={S} D={D} a in [0.999, 0.9999], h0 "
              f"(fused_bias): against float64, kernel {err:.3e}, plain "
              f"{plain_err:.3e} (bar: <= 2x plain and <= {RGLRU_RTOL:.0e}); "
              f"kernel vs plain "
              f"{float((y - wy).abs().max()) / float(wy.abs().max()):.3e}",
              flush=True)
        check(err <= 2 * plain_err and err <= RGLRU_RTOL,
              f"rglru_scan {name}: {err} from float64, the plain version "
              f"{plain_err}")
        del x, ga, gx, y, wy, truth
    # the train phases' shape (recurrentgemma-9b, one microbatch of 4096),
    # where the forward runs twice a layer and microbatch (remat full)
    x, lam, ga, gx, _, b_a, b_i = rglru_inputs(
        1, TRAIN_SEQ, 4096, torch.bfloat16, torch.bfloat16, gen)
    bias = dict(b_a=b_a, b_i=b_i)
    y, _ = ops.rglru(x, lam, ga, gx, **bias)
    wy, _ = ref.reference_rglru(x, lam, ga, gx, **bias)
    err = float((y - wy).abs().max())
    rel = err / float(wy.abs().max())
    print(f"  {'griffin-train':19s} B=1 S={TRAIN_SEQ} D=4096 (fused_bias): "
          f"max_abs_err={err:.3e} rel={rel:.3e} tol={RGLRU_RTOL:.0e}",
          flush=True)
    check(math.isfinite(rel) and rel <= RGLRU_RTOL,
          f"rglru_scan griffin-train: relative error {rel} > {RGLRU_RTOL}")
    at_train = time_rglru_kernel(x, lam, ga, gx, bias, "fused_bias", err)
    del x, ga, gx, y, wy
    torch.cuda.empty_cache()
    return {**timed["fused_bias"], "timed_route": "fused_bias",
            "at_gates_route": timed["gates"], "at_train_shape": at_train}


def time_rglru_kernel(x, lam, ga, gx, bias, route, err):
    """Kernel and plain times at x's shape on ``route``; no single PyTorch
    call computes this function, so there is no library time."""
    from repro_torch.kernels.rglru_scan import ops, ref
    B, S, D = x.shape
    kernel_ms = cuda_ms(lambda: ops.rglru(x, lam, ga, gx, **bias))
    plain_ms = cuda_ms(lambda: ref.reference_rglru(x, lam, ga, gx, **bias),
                       iters=3, warmup=1)
    bound_ms, bound_by, flops, nbytes = bound(rg_cost.work(
        B, S, D, x.dtype, ga.dtype, False, bool(bias)), torch.float32)
    print(f"  timing at B={B} S={S} D={D} x {x.dtype} gates {ga.dtype} "
          f"({route}): kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library: none; bound {bound_ms * 1e3:.2f} us by {bound_by} "
          f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), "
          f"{bound_ms / kernel_ms:.1%} of it", flush=True)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


# (name, B, S, H, Dh, q/k/v dtype, with init_state, stress); the first is
# xlstm-1.3b's prefill shape (bf16 q, k, v and float32 gates, as the bf16
# model hands them over) and is timed.  A stress case has strongly negative
# forget gates (the chunk's forget sum underflows exp) and input gates near
# 90 (exp overflows float32), which only the stabiliser m keeps finite.
# With input gates that large the floor exp(-m) of the denominator is a
# float32 denormal, so where q . n cancels toward 0, h is ill-conditioned
# for any float32 evaluation.  Here the keys lie near their queries
# ("near-keys"), which keeps q . n from 0, so the plain version is a fair
# yardstick at 1e-4; MLSTM_ORACLE_CASE takes random keys.
MLSTM_CASES = [
    ("xlstm-prefill", 4, 1000, 4, 1024, torch.bfloat16, False, None),
    ("xlstm-prefill-f32", 4, 1000, 4, 1024, torch.float32, False, None),
    ("ragged-37", 2, 37, 4, 512, torch.bfloat16, False, None),
    ("single-step", 3, 1, 4, 1024, torch.bfloat16, False, None),
    ("dh-32", 2, 200, 4, 32, torch.float32, False, None),
    ("one-head", 1, 1000, 1, 1024, torch.bfloat16, False, None),
    ("with-init", 2, 136, 4, 512, torch.float32, True, None),
    ("stress", 2, 1000, 4, 1024, torch.bfloat16, False, "near-keys"),
    ("dh-1300", 1, 100, 2, 1300, torch.float32, False, None),
    # the wgmma route's chunk (128) and its edges, a Dh that is not a
    # multiple of 64, and a bf16 input that TMA cannot address (H * Dh odd:
    # its rows are not 16-byte strided), which takes the scalar bf16 route
    ("chunk-127", 2, 127, 4, 1024, torch.bfloat16, False, None),
    ("chunk-128", 2, 128, 4, 1024, torch.bfloat16, True, None),
    ("chunk-129", 2, 129, 4, 512, torch.bfloat16, False, None),
    ("chunk-257", 2, 257, 2, 1024, torch.bfloat16, True, None),
    ("dh-96", 2, 300, 4, 96, torch.bfloat16, True, None),
    ("tma-refused", 2, 150, 1, 37, torch.bfloat16, True, None),
    # 21 chunks of 64 MiB of state: two segments of the wgmma route's
    # bounded workspace, the second starting from the first one's state
    ("segments", 1, 2600, 16, 1024, torch.bfloat16, True, None),
]
MLSTM_PLAIN_CHUNK = 256     # the block's chunk, halved until it divides S

# The stress gates with random keys, where q . n may cancel toward the
# vanishing floor: the kernel, and the plain version at chunks 8 and 64
# (S = 1024 takes both unhalved), are each held against the recurrence
# step by step in float64.  A float32 evaluation of h then misses the
# truth by more than 1e-4 of max |h|: on an H100 the plain version's h by
# 1.33e-4 at both chunks (which differ from each other by 1.3e-5) and the
# kernel's by 1.15e-4; C and n by 1.4e-5 at chunk 64, 4e-8 at chunk 8 and
# in the kernel.  So the kernel's bar for each of h, C, n and m is
# MLSTM_RTOL or, where larger, twice the plain version's own worst error
# against the truth at either chunk (as a bf16 model is held at twice the
# reference's own bf16 error).
MLSTM_ORACLE_CASE = ("stress-random-keys", 2, 1024, 4, 1024, torch.bfloat16)
MLSTM_ORACLE_CHUNKS = (8, 64)


def mlstm_inputs(B, S, H, Dh, dtype, with_init, stress, gen):
    """(q, k, v, ig, fg) and init_state or None, on the card; ``stress``
    None, "near-keys" or "random-keys"."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    q, k, v = randn(B, S, H, Dh), randn(B, S, H, Dh), randn(B, S, H, Dh)
    ig, fg = randn(B, S, H), 3.0 + randn(B, S, H)   # forget bias 3 to 6
    if stress:
        ig, fg = ig + 90.0, fg - 12.0
    if stress == "near-keys":
        k = q + 0.5 * k
    init = (randn(B, H, Dh, Dh), randn(B, H, Dh), randn(B, H)) \
        if with_init else None
    return (q.to(dtype), k.to(dtype), v.to(dtype), ig, fg), init


def rel_errs(got, want) -> dict:
    """{leaf: max |got - want| / max |want|} over h, C, n, m, in
    want's dtype."""
    rels = {}
    for what, g, w in zip("hCnm", got, want):
        scale = float(w.abs().max())
        err = float((g.to(w.dtype) - w).abs().max())
        rels[what] = err / scale if scale > 0 else err
    return rels


def mlstm_route(dtype, Dh) -> str:
    """The route of mlstm_scan a contiguous fresh input takes (ops.py's
    rule): float32 on the scalar kernels, bf16 on wgmma where TMA can
    address it (Dh a multiple of 8), else on the scalar bf16 kernels."""
    if dtype == torch.float32:
        return "scalar_f32"
    return "wgmma_bf16" if Dh % 8 == 0 else "scalar_bf16"


def phase_kernel_mlstm():
    from repro_torch.kernels.mlstm_scan import kernel, ops, ref
    phase("kernel mlstm_scan")
    gen = torch.Generator(device="cuda").manual_seed(3)
    result = None
    for name, B, S, H, Dh, dtype, with_init, stress in MLSTM_CASES:
        xs, init = mlstm_inputs(B, S, H, Dh, dtype, with_init, stress, gen)
        route = mlstm_route(dtype, Dh)
        check(ops.kernel_route(*xs[:3]) == route,
              f"mlstm_scan {name}: route {ops.kernel_route(*xs[:3])}, "
              f"expected {route}")
        before = kernel.LAUNCHES_BY_ROUTE[route]
        h, state = ops.mlstm_chunkwise(*xs, chunk=MLSTM_PLAIN_CHUNK,
                                       init_state=init)
        torch.cuda.synchronize()
        check(kernel.LAUNCHES_BY_ROUTE[route] == before + 1,
              f"mlstm_scan {name} did not run on {route}")
        # the plain version computes in float32 from the same inputs
        wh, wstate = ref.reference_mlstm(*xs, chunk=MLSTM_PLAIN_CHUNK,
                                         init_state=init)
        rels = rel_errs((h,) + state, (wh,) + wstate)
        h_err = float((h - wh).abs().max())
        bound_ms, bound_by, _, _ = bound(ml_cost.work(
            B, S, H, Dh, dtype, with_init), dtype)
        print(f"  {name:17s} {str(dtype):15s} B={B} S={S} H={H} Dh={Dh} "
              f"init={with_init} ({route}): max_abs_err(h)={h_err:.3e} "
              f"max|h|={float(wh.abs().max()):.3e} rel " + " ".join(
                  f"{k}={r:.3e}" for k, r in rels.items())
              + f" tol={MLSTM_RTOL:.0e}; bound {bound_ms * 1e3:.2f} us by "
              f"{bound_by}", flush=True)
        for what, r in rels.items():
            check(math.isfinite(r) and r <= MLSTM_RTOL,
                  f"mlstm_scan {name} {what}: relative error {r} > "
                  f"{MLSTM_RTOL}")
        if result is None:
            result = time_mlstm_kernel(xs, h_err)
        del xs, init, h, state, wh, wstate
        torch.cuda.empty_cache()
    check_mlstm_against_oracle(gen)
    return result


def check_mlstm_against_oracle(gen):
    """MLSTM_ORACLE_CASE: kernel and plain version against the float64
    recurrence, the kernel within MLSTM_RTOL or twice the plain version's
    worst error, for each of h, C, n and m."""
    from repro_torch.kernels.mlstm_scan import ops, ref
    name, B, S, H, Dh, dtype = MLSTM_ORACLE_CASE
    xs, _ = mlstm_inputs(B, S, H, Dh, dtype, False, "random-keys", gen)
    h, state = ops.mlstm_chunkwise(*xs, chunk=MLSTM_PLAIN_CHUNK)
    torch.cuda.synchronize()
    wh, wstate = ref.sequential_oracle(*xs, dtype=torch.float64)
    truth = (wh,) + wstate
    plains = {}
    for c in MLSTM_ORACLE_CHUNKS:
        ph, pstate = ref.reference_mlstm(*xs, chunk=c)
        plains[c] = (ph,) + pstate
    plain_rels = {c: rel_errs(o, truth) for c, o in plains.items()}
    got = rel_errs((h,) + state, truth)
    c0, c1 = MLSTM_ORACLE_CHUNKS
    between = rel_errs(plains[c0], plains[c1])

    def fmt(rels):
        return " ".join(f"{k}={r:.3e}" for k, r in rels.items())
    print(f"  {name} {dtype} B={B} S={S} H={H} Dh={Dh}, against the float64 "
          f"recurrence (max|h| {float(wh.abs().max()):.3e}): kernel "
          f"{fmt(got)}; " + "; ".join(f"plain at chunk {c} {fmt(r)}"
                                      for c, r in plain_rels.items())
          + f"; plain at chunk {c0} against chunk {c1} {fmt(between)}",
          flush=True)
    for what, r in got.items():
        bar = max(MLSTM_RTOL,
                  2 * max(pr[what] for pr in plain_rels.values()))
        check(math.isfinite(r) and r <= bar,
              f"mlstm_scan {name} {what}: error {r} against the float64 "
              f"recurrence > {bar}")
    del xs, h, state, wh, wstate, truth, plains
    torch.cuda.empty_cache()


def time_mlstm_kernel(xs, err):
    """Kernel and plain times at the serving shape; no PyTorch call
    computes this function, so there is no library time.  Also the time of
    each kernel the call launches (by the profiler, over the same calls)
    and, beside it, the scalar bf16 kernels on the same inputs."""
    from repro_torch.kernels.mlstm_scan import kernel, ops, ref
    B, S, H, Dh = xs[0].shape
    route = ops.kernel_route(*xs[:3])
    kernel_ms = cuda_ms(lambda: ops.mlstm_chunkwise(
        *xs, chunk=MLSTM_PLAIN_CHUNK))
    plain_ms = cuda_ms(lambda: ref.reference_mlstm(
        *xs, chunk=MLSTM_PLAIN_CHUNK), iters=3, warmup=1)
    f32 = dict(dtype=torch.float32, device="cuda")
    outs = (torch.empty((B, S, H, Dh), **f32),
            torch.empty((B, H, Dh, Dh), **f32), torch.empty((B, H, Dh), **f32),
            torch.empty((B, H), **f32))
    scalar_ms = cuda_ms(lambda: kernel.launch(*xs, None, *outs,
                                              "scalar_bf16"), iters=5)
    passes = kernel_passes_ms(lambda: ops.mlstm_chunkwise(
        *xs, chunk=MLSTM_PLAIN_CHUNK), r"mlstm_\w+(<[^()]*>)?")
    ws = kernel.workspace_bytes(B, S, H, Dh, route)
    bound_ms, bound_by, flops, nbytes = bound(ml_cost.work(
        B, S, H, Dh, xs[0].dtype, False), xs[0].dtype)
    print(f"  timing at B={B} S={S} H={H} Dh={Dh} q/k/v {xs[0].dtype} gates "
          f"{xs[3].dtype} ({route}): kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library: none, scalar_bf16 kernels "
          f"{scalar_ms:.4f} ms; bound {bound_ms * 1e3:.2f} us by {bound_by} "
          f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); workspace "
          f"{ws} B", flush=True)
    if passes:
        print("  passes of one call (profiler, mean of 10 calls): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in passes.items()),
              flush=True)
    else:
        print("  passes of one call: not measured (the profiler saw no "
              "kernels)", flush=True)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_route": route, "passes_ms": passes,
            "workspace_bytes": ws, "scalar_bf16_ms": scalar_ms}


# rglru_scan's backward against its plain version (explicit formulas in
# float32 on the same inputs and the forward's y), each gradient relative
# to the plain one's max |.|:
#  * bf16 dx, dga, dgx: rounded to bf16 on output (2**-9 of the value);
#    2e-2 as the other bf16 bars;
#  * float32 gradients, and dlam, db_a, db_i, dh0 in either dtype: the same
#    float32 formulas in another order (the carry composed over windows
#    and their segments, the per-channel sums over B * S from per-block
#    partials); ~1e-6 apart, 1e-4 is the bar.
RGLRU_BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

# (name, B, S, D, h0, dh_last, fused biases, x and ga off a 16-byte
# boundary), each run with bf16 and with float32 x and gates: the train
# phase's own shape (recurrentgemma-9b, one microbatch of 4096; h_last
# unused, as in training), timed in bf16; S 1, 63, 64, 65, 129 (the first
# kernel's 64-step chunks), D not a multiple of 8 or of the block's 32
# channels (77, 200, 4100), h0 and dh_last, both routes; then the windowed
# kernel's edges: its windows (64 steps for float32 gates, 128 for bf16:
# S 127, 128), many windows, the last ragged, at D 512 and 1024 (16 and
# 32 blocks; S 1023 and 1025 either side of a multiple of both windows;
# B 2), and x and ga off a 16-byte boundary (staged with plain loads).
RGLRU_BWD_CASES = [
    ("griffin-train", 1, TRAIN_SEQ, 4096, False, False, True, False),
    ("single-step", 2, 1, 256, True, True, True, False),
    ("chunk-63", 3, 63, 77, True, True, False, False),
    ("chunk-64", 2, 64, 128, False, True, True, False),
    ("chunk-65", 2, 65, 200, True, False, True, False),
    ("chunk-129", 1, 129, 4100, True, True, True, False),
    ("gates-1000", 2, 1000, 512, True, True, False, False),
    ("window-127", 2, 127, 96, True, True, True, False),
    ("window-128", 1, 128, 64, False, True, False, False),
    ("windows-1100", 2, 1100, 512, True, True, True, False),
    ("windows-1023", 1, 1023, 1024, False, True, True, False),
    ("windows-1025", 1, 1025, 1024, True, False, True, False),
    ("b2-windows", 2, 2048, 1024, True, True, True, False),
    ("off-16-bytes", 2, 100, 256, True, True, True, True),
]
# a from 0.999 to 0.9999 over 4096 steps, float32, from h0 with dh_last:
# the carry runs through thousands of a near 1, where every float32
# evaluation drifts from the truth (as the forward's long-memory case), so
# the kernel's gradients are held against autograd of the recurrence in
# float64, at most twice the plain version's own error, or 1e-4 where that
# is larger
RGLRU_BWD_ORACLE_CASE = ("long-memory-4096", 2, 4096, 512)


def rglru_grads(x, lam, ga, gx, h0, b_a, b_i, dy, dh_last):
    """The gradients (x, lam, ga, gx, h0, b_a, b_i; None where not given)
    through ``ops.rglru``'s autograd function, and its y."""
    from repro_torch.kernels.rglru_scan import ops
    leaves = [None if t is None else t.detach().requires_grad_()
              for t in (x, lam, ga, gx, h0, b_a, b_i)]
    y, h_last = ops.rglru(*leaves[:5], b_a=leaves[5], b_i=leaves[6])
    outs, cots = ([y, h_last], [dy, dh_last]) if dh_last is not None \
        else ([y], [dy])
    given = [t for t in leaves if t is not None]
    got = iter(torch.autograd.grad(outs, given, cots))
    return [None if t is None else next(got) for t in leaves], y.detach()


def grad_errors(got, want, floor_frac=BWD_SCALE_FLOOR):
    """Each gradient's max error over the plain one's max |.|, floored at
    ``floor_frac`` of the largest of them (None stays None)."""
    scales = [float(w.abs().max()) for w in want if w is not None]
    floor = floor_frac * max(scales)
    return [None if w is None else
            float((g.float() - w.float()).abs().max()) /
            max(float(w.abs().max()), floor) for g, w in zip(got, want)]


def off_16_bytes(t):
    """t's values in a contiguous tensor 2 or 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def phase_kernel_rglru_bwd():
    """rglru_scan's backward through ``ops.rglru`` under grad against the
    plain backward, both dtypes; returns the timing at the train shape."""
    from repro_torch.kernels.rglru_scan import kernel, ref
    phase("kernel_bwd rglru_scan")
    gen = torch.Generator(device="cuda").manual_seed(4)
    names = ("dx", "dlam", "dga", "dgx", "dh0", "db_a", "db_i")
    timing = None
    for name, B, S, D, with_h0, with_dhl, fused, off16 in RGLRU_BWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            x, lam, ga, gx, h0, b_a, b_i = rglru_inputs(B, S, D, dtype,
                                                        dtype, gen)
            if off16:
                x, ga = off_16_bytes(x), off_16_bytes(ga)
            h0 = h0 if with_h0 else None
            b_a, b_i = (b_a, b_i) if fused else (None, None)
            dy = torch.randn((B, S, D), generator=gen, device="cuda")
            dh_last = torch.randn((B, D), generator=gen, device="cuda") \
                if with_dhl else None
            route = "fused_bias" if fused else "gates"
            before = (kernel.BWD_LAUNCHES_BY_ROUTE[route],
                      kernel.LAUNCHES_BY_ROUTE[route])
            got, y = rglru_grads(x, lam, ga, gx, h0, b_a, b_i, dy, dh_last)
            torch.cuda.synchronize()
            check((kernel.BWD_LAUNCHES_BY_ROUTE[route],
                   kernel.LAUNCHES_BY_ROUTE[route]) ==
                  (before[0] + 1, before[1] + 1),
                  f"rglru_scan backward {name} {dtype} did not run on "
                  f"{route}")
            again, _ = rglru_grads(x, lam, ga, gx, h0, b_a, b_i, dy,
                                   dh_last)
            check(all(a is None or torch.equal(a, b)
                      for a, b in zip(got, again)),
                  f"rglru_scan backward {name} {dtype}: a second call gave "
                  f"other bits")
            want = ref.reference_rglru_bwd(x, lam, ga, gx, y, dy, h0,
                                           dh_last, b_a=b_a, b_i=b_i)
            errs = grad_errors(got, want)
            tols = [RGLRU_BWD_TOL[dtype] if k in ("dx", "dga", "dgx")
                    else RGLRU_BWD_TOL[torch.float32] for k in names]
            abs_err = max(float((g.float() - w.float()).abs().max())
                          for g, w in zip(got, want) if w is not None)
            print(f"  {name:15s} {str(dtype):15s} B={B} S={S} D={D} "
                  f"h0={with_h0} dh_last={with_dhl} ({route}"
                  f"{', off 16 bytes' if off16 else ''}; repeat "
                  f"bit-identical): rel err "
                  + " ".join(f"{k} {e:.3e}" for k, e in zip(names, errs)
                             if e is not None), flush=True)
            check(all(e is None or (math.isfinite(e) and e <= t)
                      for e, t in zip(errs, tols)),
                  f"rglru_scan backward {name} {dtype}: errors {errs}")
            if name == "griffin-train" and dtype == torch.bfloat16:
                timing = time_rglru_bwd(x, lam, ga, gx, b_a, b_i, y, dy,
                                        abs_err)
            del x, ga, gx, y, dy, got, again, want
    check_rglru_bwd_against_oracle(gen)
    torch.cuda.empty_cache()
    return timing


def check_rglru_bwd_against_oracle(gen):
    from repro_torch.kernels.rglru_scan import ref
    name, B, S, D = RGLRU_BWD_ORACLE_CASE
    x, lam, ga, gx, h0, b_a, b_i = rglru_inputs(
        B, S, D, torch.float32, torch.float32, gen, u=(0.999, 0.9999))
    dy = torch.randn((B, S, D), generator=gen, device="cuda")
    dh_last = torch.randn((B, D), generator=gen, device="cuda")
    got, y = rglru_grads(x, lam, ga, gx, h0, b_a, b_i, dy, dh_last)
    plain = ref.reference_rglru_bwd(x, lam, ga, gx, y, dy, h0, dh_last,
                                    b_a=b_a, b_i=b_i)
    leaves = [t.double().requires_grad_()
              for t in (x, lam, ga, gx, h0, b_a, b_i)]
    y64 = ref.oracle_rglru(*leaves[:5], b_a=leaves[5], b_i=leaves[6])
    truth = torch.autograd.grad(
        (y64 * dy.double()).sum() + (y64[:, -1] * dh_last.double()).sum(),
        leaves)
    errs = grad_errors(got, truth)
    plain_errs = grad_errors(plain, truth)
    print(f"  {name} B={B} S={S} D={D} a in [0.999, 0.9999], h0, dh_last, "
          f"float32 (fused_bias): against autograd in float64, kernel "
          + " ".join(f"{e:.3e}" for e in errs) + "; plain "
          + " ".join(f"{e:.3e}" for e in plain_errs), flush=True)
    for e, pe in zip(errs, plain_errs):
        check(math.isfinite(e) and e <= max(RGLRU_BWD_TOL[torch.float32],
                                            2 * pe),
              f"rglru_scan backward {name}: {errs} against float64, the "
              f"plain version {plain_errs}")


def time_rglru_bwd(x, lam, ga, gx, b_a, b_i, y, dy, err):
    """The backward kernel (and each kernel one call launches, by the
    profiler, mean of ten calls) and the plain backward at the train shape;
    no PyTorch call computes this gradient, so no library time."""
    from repro_torch.kernels.rglru_scan import kernel, ref
    B, S, D = x.shape
    f32 = dict(dtype=torch.float32, device="cuda")
    dx, dga, dgx = (torch.empty_like(t) for t in (x, ga, gx))
    dlam, db_a, db_i = (torch.empty((D,), **f32) for _ in range(3))

    def run():
        kernel.launch_bwd(x, lam, ga, gx, b_a, b_i, None, y, dy, None, dx,
                          dga, dgx, dlam, db_a, db_i, None)
    kernel_ms = cuda_ms(run)
    passes = kernel_passes_ms(run, r"rglru_bwd\w*")
    plain_ms = cuda_ms(lambda: ref.reference_rglru_bwd(
        x, lam, ga, gx, y, dy, b_a=b_a, b_i=b_i), iters=2, warmup=1)
    bound_ms, bound_by, flops, nbytes = bound(rg_cost.bwd_work(
        B, S, D, x.dtype, b_a is not None), torch.float32)
    print(f"  backward timing at B={B} S={S} D={D} {x.dtype} (fused_bias): "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library: "
          f"none; bound {bound_ms * 1e3:.2f} us by {bound_by} "
          f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), "
          f"{bound_ms / kernel_ms:.1%} of it; passes (profiler, mean of 10 "
          f"calls) " + (", ".join(f"{k} {v:.4f} ms" for k, v in
                                  passes.items()) or "not measured"),
          flush=True)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "passes_ms": passes}


# mlstm_scan's backward against its plain version (explicit formulas in
# float32, on the same inputs, the forward's h and its row statistics),
# each gradient relative to the plain one's max |.|, floored at 1e-3 of the
# largest of dq, dk, dv (or of dig, dfg):
#  * bf16 dq, dk, dv: rounded to bf16 on output; 2e-2 as the other bf16
#    bars;
#  * float32 dq, dk, dv, and dig and dfg in both dtypes: the same float32
#    formulas in another order (chunks of 64 on the card, sums over Dh and
#    S); ~1e-6 apart, 1e-4 is the bar.
# With one step (S 1) h does not depend on fg (F_t - F_s = 0), and where the
# clamp is inactive h = v sign(q . k): dfg, and dq and dk, vanish in exact
# arithmetic and hold only rounding, so each is held against the largest
# scale of its group.
MLSTM_BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

# (name, B, S, H, Dh, with init_state, stress), each in bf16 and float32:
# the train phase's own shape (xlstm-1.3b's mLSTM at train_4k, one
# microbatch), timed in bf16; S not a multiple of either chunk (200); S 1;
# input gates lowered by 8, so that the denominator's floor exp(-m) takes
# most rows ("clamp"); a constant initial state; Dh 1600, past which a
# state slab leaves shared memory; Dh 37, whose bf16 forward takes the
# scalar route.
MLSTM_BWD_CASES = [
    ("xlstm-train", 1, TRAIN_SEQ, 4, 1024, False, None),
    ("ragged-200", 2, 200, 4, 512, False, None),
    ("single-step", 2, 1, 4, 256, False, None),
    ("clamp-active", 1, 300, 4, 256, False, "clamp"),
    ("with-init", 2, 136, 4, 512, True, None),
    ("dh-1600", 1, 100, 1, 1600, False, None),
    ("dh-37", 2, 150, 1, 37, True, None),
]


def phase_kernel_mlstm_bwd():
    """mlstm_scan's backward through ``ops.mlstm_chunkwise`` under grad
    against the plain backward, both dtypes, and the forward's row
    statistics against the plain ones; returns the timing at the train
    shape."""
    from repro_torch.kernels.mlstm_scan import kernel, ops, ref
    phase("kernel_bwd mlstm_scan")
    gen = torch.Generator(device="cuda").manual_seed(5)
    names = ("dq", "dk", "dv", "dig", "dfg")
    timing = None
    for name, B, S, H, Dh, with_init, stress in MLSTM_BWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            (q, k, v, ig, fg), init = mlstm_inputs(B, S, H, Dh, dtype,
                                                   with_init, None, gen)
            if stress == "clamp":
                ig = ig - 8.0
            dh = torch.randn((B, S, H, Dh), generator=gen, device="cuda")
            route = mlstm_route(dtype, Dh)
            check(ops.kernel_route(q, k, v) == route,
                  f"mlstm_scan backward {name} {dtype}: inputs on route "
                  f"{ops.kernel_route(q, k, v)}, not {route}")
            bwd_route = route   # the backward takes its forward's route
            leaves = [t.requires_grad_() for t in (q, k, v, ig, fg)]
            before = (kernel.BWD_LAUNCHES_BY_ROUTE[bwd_route],
                      kernel.LAUNCHES_BY_ROUTE[route])
            h, _ = ops.mlstm_chunkwise(*leaves, chunk=MLSTM_PLAIN_CHUNK,
                                       init_state=init)
            m_t, den = h.grad_fn.saved_tensors[-2:]
            got = torch.autograd.grad(h, leaves, dh)
            torch.cuda.synchronize()
            check((kernel.BWD_LAUNCHES_BY_ROUTE[bwd_route],
                   kernel.LAUNCHES_BY_ROUTE[route]) ==
                  (before[0] + 1, before[1] + 1),
                  f"mlstm_scan backward {name} {dtype} did not run on "
                  f"{bwd_route} after a forward on {route}")
            xs = [t.detach() for t in leaves]
            # the forward's statistics against the plain ones
            pm, pden, _ = ref.reference_mlstm_stats(*xs, init_state=init)
            m_err = float((m_t - pm).abs().max()) / \
                max(float(pm.abs().max()), 1.0)
            den_err = float((den - pden).abs().max()) / \
                float(pden.abs().max())
            want = ref.reference_mlstm_bwd(*xs, h.detach(), (m_t, den), dh,
                                           init_state=init)
            errs = grad_errors(got[:3], want[:3]) + \
                grad_errors(got[3:], want[3:])
            if S == 1:
                top = max(float(w.abs().max()) for w in want[:3])
                errs[:2] = [float((g.float() - w).abs().max()) / top
                            for g, w in zip(got[:2], want[:2])]
                errs[4] = float((got[4] - want[4]).abs().max()) / \
                    max(float(w.abs().max()) for w in want[3:])
            tols = [MLSTM_BWD_TOL[dtype]] * 3 + \
                [MLSTM_BWD_TOL[torch.float32]] * 2
            clamped = float((den.abs() <= torch.exp(-m_t)).float().mean())
            abs_err = max(float((g.float() - w).abs().max())
                          for g, w in zip(got, want))
            print(f"  {name:13s} {str(dtype):15s} B={B} S={S} H={H} Dh={Dh} "
                  f"init={with_init} ({route} -> {bwd_route}), clamped rows "
                  f"{clamped:.1%}: rel err " + " ".join(
                      f"{k} {e:.3e}" for k, e in zip(names, errs))
                  + f"; stats m {m_err:.3e} den {den_err:.3e}", flush=True)
            check(all(math.isfinite(e) and e <= t
                      for e, t in zip(errs, tols)),
                  f"mlstm_scan backward {name} {dtype}: errors {errs}")
            check(m_err <= MLSTM_RTOL and den_err <= MLSTM_RTOL,
                  f"mlstm_scan forward {name} {dtype}: row statistics "
                  f"m {m_err}, den {den_err}")
            if name == "xlstm-train" and dtype == torch.bfloat16:
                timing = time_mlstm_bwd(xs, h.detach(), (m_t, den), dh,
                                        abs_err, bwd_route)
            del q, k, v, ig, fg, leaves, h, got, want, xs
            torch.cuda.empty_cache()
    return timing


def time_mlstm_bwd(xs, h, stats, dh, err, route):
    """The backward on ``route`` (each of its passes by the profiler), the
    scalar bf16 route on the same inputs and the plain backward, at the
    train shape; no PyTorch call computes this gradient, so no library
    time."""
    from repro_torch.kernels.mlstm_scan import kernel, ref
    q, k, v, ig, fg = xs
    B, S, H, Dh = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dig, rows = torch.empty_like(ig), torch.empty_like(ig)

    def run(on=route):
        kernel.launch_bwd(q, k, v, ig, fg, None, h, stats, dh, dq, dk, dv,
                          dig, rows, on)
    kernel_ms = cuda_ms(run, iters=10, warmup=1)
    scalar_ms = cuda_ms(lambda: run("scalar_bf16"), iters=3, warmup=1)
    plain_ms = cuda_ms(lambda: ref.reference_mlstm_bwd(
        q, k, v, ig, fg, h, stats, dh), iters=2, warmup=1)
    passes = kernel_passes_ms(run, r"mlstm_(bwd_\w+|gates_kernel|"
                                   r"states_kernel|qk_kernel)(<[^()]*>)?", 3)
    bound_ms, bound_by, flops, nbytes = bound(ml_cost.bwd_work(
        B, S, H, Dh, q.dtype), q.dtype)
    f32_bound_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
    print(f"  backward timing at B={B} S={S} H={H} Dh={Dh} {q.dtype} "
          f"({route}, chunk {kernel.bwd_chunk(route)}): kernel "
          f"{kernel_ms:.4f} ms, scalar_bf16 {scalar_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library: none; bound {bound_ms * 1e3:.2f} us "
          f"by {bound_by} ({flops / 1e9:.2f} GFLOP at chunks of "
          f"{ml_cost.BWD_CHUNK}, {nbytes / 1e6:.2f} MB; "
          f"{f32_bound_ms:.3f} ms at the float32 rate); passes "
          + (", ".join(f"{k} {v:.4f} ms" for k, v in passes.items())
             or "not measured"), flush=True)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "float32_rate_bound_ms": f32_bound_ms, "passes_ms": passes,
            "scalar_bf16_ms": scalar_ms}


# moe_gmm's autograd function (the kernel's forward, the backward kernel of
# csrc/moe_gmm_bwd.cu on the same route) against the backward by formula in
# float32 on the same upcast inputs, and against autograd of the plain
# forward, each gradient relative to the plain one's max |.| (floored at
# 1e-3 of the largest):
#  * bf16: the kernel rounds h, da1, da3 and every output to bf16 (2**-9 of
#    the value each), ~4e-3 of the scale in its CPU emulation; 2e-2 is the
#    bar, as for the forward;
#  * float32: summation order only (no TF32); 1e-4.
GMM_BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# (name, E, C, d, f, act, gated, tokens): the fills of a seeded top-8
# routing of ``tokens`` tokens, clamped to C (granite's train shape: one
# microbatch of 4096 tokens at capacity factor 1.25, and its prefill of
# 4 x 1000), or, with None, random fills with an empty bucket, a full one
# and an expert no token reached; the rows past each fill hold data (the
# function's contract lets a pad row hold anything), NaN in the cases of
# GMM_BWD_NAN_PADS
GMM_BWD_CASES = [
    ("granite-train", 40, 1024, 1536, 512, "swiglu", True, 4096),
    ("granite-prefill", 40, 1000, 1536, 512, "swiglu", True, 4000),
    ("ragged-136", 4, 136, 256, 512, "swiglu", True, None),
    ("odd-d-f", 3, 100, 211, 333, "swiglu", True, None),
    ("geglu-200", 8, 200, 200, 328, "geglu", True, None),
    ("relu2-no-w3", 6, 130, 136, 72, "relu2", False, None),
    ("gelu-no-w3", 5, 40, 64, 64, "gelu", False, None),
    ("nan-pads", 6, 130, 256, 384, "swiglu", True, None),
    ("nan-pads-odd", 3, 100, 211, 333, "geglu", True, None),
]
GMM_BWD_NAN_PADS = {"nan-pads", "nan-pads-odd"}


def random_fills(E, C, gen):
    counts = torch.randint(0, C + 1, (E,), generator=gen, device="cuda")
    counts[0], counts[-1] = 0, C
    counts[1::5] = 0
    return counts.to(torch.int32)


def phase_kernel_moe_bwd():
    """moe_gmm under grad: ``ExpertFFNFunction``'s gradients (its forward
    kernel and its backward kernel, one launch each on the route the
    inputs pick, no call of the plain backward) against the plain backward
    and autograd of the plain forward on every route, pads with data in
    them (NaN in two cases); granite's train shape timed.  Returns the
    timing."""
    from repro_torch.kernels.moe_gmm import kernel, ops, ref
    phase("kernel_bwd moe_gmm")
    gen = torch.Generator(device="cuda").manual_seed(4)
    real_plain = ref.reference_expert_ffn_bwd
    plain_calls = []

    def counted_plain(*args, **kwargs):
        plain_calls.append(1)
        return real_plain(*args, **kwargs)
    result = None
    for name, E, C, d, f, act, gated, tokens in GMM_BWD_CASES:
        if tokens is None:
            counts = random_fills(E, C, gen)
        else:
            counts = routed_fills(E, tokens, 8, gen)[0].clamp(max=C)
        n_live = int(counts.sum())
        x32 = torch.randn((E, C, d), generator=gen, device="cuda")
        p32 = {"w1": torch.randn((E, d, f), generator=gen, device="cuda")
               / math.sqrt(d),
               "w2": torch.randn((E, f, d), generator=gen, device="cuda")
               / math.sqrt(f)}
        if gated:
            p32["w3"] = torch.randn((E, d, f), generator=gen,
                                    device="cuda") / math.sqrt(d)
        dy32 = torch.randn((E, C, d), generator=gen, device="cuda")
        pads = ~ref.live_rows(x32, counts)
        if name in GMM_BWD_NAN_PADS:
            x32[pads] = float("nan")
            dy32[pads] = float("nan")
        names = ["w1", "w3", "w2"] if gated else ["w1", "w2"]
        for dtype in (torch.bfloat16, torch.float32):
            xe = x32.to(dtype).requires_grad_()
            masters = {k: w.clone().requires_grad_() for k, w in p32.items()}
            dy = dy32.to(dtype)
            route = gmm_route(dtype, d, f)
            before = (kernel.LAUNCHES_BY_ROUTE[route],
                      kernel.BWD_LAUNCHES_BY_ROUTE[route],
                      kernel.BWD_LAUNCHES)
            plain_calls.clear()
            ref.reference_expert_ffn_bwd = counted_plain
            try:
                y = ops.expert_ffn(xe, masters, act, counts)
                check(y.grad_fn is not None,
                      f"moe_gmm {name}: no grad_fn under grad")
                got = torch.autograd.grad(
                    y, [xe] + [masters[k] for k in names], dy)
                torch.cuda.synchronize()
            finally:
                ref.reference_expert_ffn_bwd = real_plain
            check((kernel.LAUNCHES_BY_ROUTE[route],
                   kernel.BWD_LAUNCHES_BY_ROUTE[route],
                   kernel.BWD_LAUNCHES) ==
                  (before[0] + 1, before[1] + 1, before[2] + 1)
                  and not plain_calls,
                  f"moe_gmm {name} {dtype}: not one forward and one "
                  f"backward launch on {route}, or {len(plain_calls)} calls "
                  f"of the plain backward")
            # both references in float32 on the inputs the function saw;
            # autograd's on the pads zeroed (its products would carry a
            # NaN there into every weight's gradient)
            x_in = xe.detach().float()
            p_in = {k: w.to(dtype).float() for k, w in p32.items()}
            dxe, dw1, dw3, dw2 = real_plain(x_in, p_in, dy.float(), act,
                                            counts)
            want = [dxe, dw1] + ([dw3] if gated else []) + [dw2]
            leaves = {k: w.clone().requires_grad_() for k, w in p_in.items()}
            x_auto = x_in.masked_fill(pads[..., None], 0.0).requires_grad_()
            auto = torch.autograd.grad(
                ref.reference_expert_ffn(x_auto, leaves, act, counts),
                [x_auto] + [leaves[k] for k in names],
                dy.float().masked_fill(pads[..., None], 0.0))
            errs = grad_errors(got, want)
            errs_auto = grad_errors(got, auto)
            err = max(float((g.float() - w).abs().max())
                      for g, w in zip(got, want))
            tol = GMM_BWD_TOL[dtype]
            rels = " ".join(f"d{k} {e:.2e}"
                            for k, e in zip(["xe"] + names, errs))
            print(f"  {name:16s} {str(dtype):15s} E={E} C={C} d={d} f={f} "
                  f"{act}{'' if gated else ' no w3'}, {n_live} live rows"
                  f"{', NaN in the pads' if name in GMM_BWD_NAN_PADS else ''}"
                  f" ({route}, forward and backward kernels): rel errs "
                  f"{rels} against the plain backward, max "
                  f"{max(errs_auto):.2e} against autograd (tol {tol:.0e})",
                  flush=True)
            check(all(math.isfinite(e) and e <= tol
                      for e in errs + errs_auto),
                  f"moe_gmm backward {name} {dtype}: errors {errs}, "
                  f"against autograd {errs_auto} (tol {tol})")
            check(not got[0][pads].any(),
                  f"moe_gmm backward {name} {dtype}: dxe is not 0 on a pad")
            if name == "granite-train" and dtype == torch.bfloat16:
                result = time_moe_bwd(xe.detach(), p32, dy, act, counts,
                                      n_live, err)
            del xe, masters, got, want, auto, leaves, x_auto, x_in, p_in
        del x32, p32, dy32
        torch.cuda.empty_cache()
    return result


def time_moe_bwd(xe, p32, dy, act, counts, n_live, err):
    """At granite's train shape in bf16: the backward kernel and the plain
    backward in turns (plain, kernel, kernel, plain), the kernel repeated
    bit for bit; the function's forward and backward, the kernel's forward
    alone, and plain autograd's forward and backward, by CUDA events in
    this call, beside the bound of the backward (six products over the live
    rows at the bf16 rate, or its bytes), of the kernel's own work (eight:
    a1 and a3 recomputed) and of forward and backward (nine)."""
    from repro_torch.kernels.moe_gmm import ops, ref
    E, C, d = xe.shape
    f = p32["w1"].shape[-1]
    w = {k: t.to(xe.dtype).requires_grad_() for k, t in p32.items()}
    x = xe.requires_grad_()
    leaves = [x, w["w1"], w["w3"], w["w2"]]
    wd = {k: t.detach() for k, t in w.items()}

    def kernel_bwd():
        return ops.expert_ffn_bwd(x.detach(), wd["w1"], wd["w3"], wd["w2"],
                                  dy, counts, act)

    def plain_bwd():
        return ref.reference_expert_ffn_bwd(x.detach(), wd, dy, act, counts)
    first, again = kernel_bwd(), kernel_bwd()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "moe_gmm backward: two calls on the same inputs differ")
    del first, again
    plain_ms = [cuda_ms(plain_bwd, iters=10)]
    kernel_ms = [cuda_ms(kernel_bwd, iters=10) for _ in range(2)]
    plain_ms.append(cuda_ms(plain_bwd, iters=10))
    fn_ms = cuda_ms(lambda: torch.autograd.grad(
        ops.expert_ffn(x, w, act, counts), leaves, dy), iters=10)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: ops.expert_ffn(x, w, act, counts),
                         iters=10)
    plain_fb_ms = cuda_ms(lambda: torch.autograd.grad(
        ref.reference_expert_ffn(x, w, act, counts), leaves, dy), iters=10)
    elem = xe.element_size()
    bound_ms, bound_by, flops, nbytes = bound(gmm_cost.bwd_work(
        n_live, E, d, f, True, xe.dtype), xe.dtype)
    t_ops = flops / PEAK_FLOPS[xe.dtype]
    own_ms = max(t_ops * 8 / 6, nbytes / HBM_BW) * 1e3
    fb_bound_ms = max(1.5 * t_ops, (nbytes + elem * (2 * n_live * d + 3 * E
                                                     * d * f))
                      / HBM_BW) * 1e3
    ms = min(kernel_ms)
    print(f"  timing at granite's train shape (E={E} C={C} d={d} f={f} "
          f"{xe.dtype}, {n_live} live rows): the backward kernel "
          f"(wgmma_bf16) {kernel_ms[0]:.4f}, {kernel_ms[1]:.4f} ms, the "
          f"plain backward (grouped torch.bmm, h recomputed) "
          f"{plain_ms[0]:.4f}, {plain_ms[1]:.4f} ms ({min(plain_ms) / ms:.2f}"
          f"x); the function forward + backward {fn_ms:.4f} ms (the "
          f"kernel's forward {fwd_ms:.4f} ms); plain autograd forward + "
          f"backward {plain_fb_ms:.4f} ms; bound of the backward "
          f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB; {bound_ms / ms:.1%} of it reached), of "
          f"the kernel's eight products {own_ms:.4f} ms, of forward + "
          f"backward {fb_bound_ms:.4f} ms", flush=True)
    return {"kernel_route": "wgmma_bf16", "max_abs_err": err, "ms": ms,
            "kernel_ms_runs": kernel_ms, "plain_ms": min(plain_ms),
            "plain_ms_runs": plain_ms, "fwd_bwd_ms": fn_ms,
            "kernel_fwd_ms": fwd_ms, "plain_fwd_bwd_ms": plain_fb_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "eight_products_bound_ms": own_ms,
            "fwd_bwd_bound_ms": fb_bound_ms, "library_ms": None,
            "live_rows": n_live}


def layer_counts(cfg) -> dict:
    """{block kind: number of layers} of a config's pattern."""
    counts: dict = {}
    for n in range(cfg.n_layers):
        kind = cfg.block_pattern[n % cfg.pattern_period]
        counts[kind] = counts.get(kind, 0) + 1
    return counts


def phase_serve(arch: str, moe_dispatch: str = "einsum",
                profile_len=None, prompt_len=None, n_layers=None):
    """Serve SERVE_REQUESTS requests of ``prompt_len`` tokens (default
    PROMPT_LEN) of ``arch`` at full width, depth cut to ``n_layers`` if
    given, through ``serve()``; returns (cfg, params, launches of each
    kernel, {kernel: launches by route} of flash_attention, moe_gmm,
    rglru_scan and mlstm_scan).  The profiled prefill takes the first
    ``profile_len`` prompt tokens (default: all of them)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
    from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
    from repro_torch.kernels.rglru_scan import kernel as rg_kernel
    from repro_torch.launch.serve import Request, serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import registry as R
    prompt_len = prompt_len or PROMPT_LEN
    profile_len = profile_len or prompt_len
    cfg = get_arch(arch)
    cut = ""
    if n_layers is not None:
        cut = f", depth cut to {n_layers} of {cfg.n_layers} layers"
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    phase(f"serve {arch}{cut}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = R.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = R.count_params_analytic(cfg)
    active = R.count_params_analytic(cfg, active_only=True)
    print(f"  {cfg.name}: {cfg.n_layers} layers{cut}, d={cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params ({active / 1e9:.3f} B active) in "
          f"{cfg.dtype}, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"on the card, init {time.perf_counter() - t0:.2f} s; "
          f"moe_dispatch={moe_dispatch}", flush=True)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(1, cfg.vocab_size, size=prompt_len)
                    .astype(np.int32), GEN) for i in range(SERVE_REQUESTS)]
    ctx_len = prompt_len + GEN

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_kernel.reset_launches()
    gmm_kernel.reset_launches()
    rg_kernel.reset_launches()
    ml_kernel.reset_launches()
    t0 = time.perf_counter()
    done = serve(cfg, reqs, slots=SERVE_SLOTS, ctx_len=ctx_len,
                 params=params, moe_dispatch=moe_dispatch, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa_kernel.LAUNCHES,
                "moe_gmm": gmm_kernel.LAUNCHES,
                "rglru_scan": rg_kernel.LAUNCHES,
                "mlstm_scan": ml_kernel.LAUNCHES}
    fa_routes = dict(fa_kernel.LAUNCHES_BY_ROUTE)
    gmm_routes = dict(gmm_kernel.LAUNCHES_BY_ROUTE)
    rg_routes = dict(rg_kernel.LAUNCHES_BY_ROUTE)
    ml_routes = dict(ml_kernel.LAUNCHES_BY_ROUTE)
    peak = torch.cuda.max_memory_allocated()

    n_prefill = math.ceil(SERVE_REQUESTS / SERVE_SLOTS)
    # each batch decodes until every slot holds GEN tokens, and one step
    # more that finds them all done: GEN decode calls per batch
    n_decode = n_prefill * GEN
    check(len(done) == SERVE_REQUESTS, f"{len(done)} requests served")
    for r in done:
        check(len(r.generated) == GEN,
              f"request {r.rid} got {len(r.generated)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.generated),
              f"request {r.rid}: token outside the vocab")
    kinds = layer_counts(cfg)
    n_attn = sum(kinds.get(k, 0) for k in ("attn", "swa", "local"))
    n_rglru = kinds.get("rglru", 0)
    n_mlstm = kinds.get("mlstm", 0)
    want = {"flash_attention": n_attn * n_prefill,
            "moe_gmm": cfg.n_layers * (n_prefill + n_decode)
            if cfg.is_moe and moe_dispatch == "gather" else 0,
            "rglru_scan": n_rglru * n_prefill,
            "mlstm_scan": n_mlstm * n_prefill}
    for name, n in want.items():
        check(launches[name] == n,
              f"{name} launched {launches[name]} times, expected {n}")
    # a bf16 model's attention runs on the wgmma route only
    fa_route = fa_kernel.ROUTES[getattr(torch, cfg.dtype)][1]
    check(fa_routes == {r: launches["flash_attention"] if r == fa_route else 0
                        for r in fa_routes},
          f"flash_attention launches by route {fa_routes}: a {cfg.dtype} "
          f"model must take {fa_route} only")
    # and its mLSTM layers and expert FFNs the wgmma route (contiguous
    # fresh q, k, v; buckets with d and f multiples of 8)
    check(cfg.dtype == "bfloat16", f"served in {cfg.dtype}")
    check(gmm_routes == {r: launches["moe_gmm"] if r == "wgmma_bf16" else 0
                         for r in gmm_routes},
          f"moe_gmm launches by route {gmm_routes}: a bfloat16 model must "
          f"take wgmma_bf16 only")
    check(ml_routes == {r: launches["mlstm_scan"] if r == "wgmma_bf16" else 0
                        for r in ml_routes},
          f"mlstm_scan launches by route {ml_routes}: a bfloat16 model must "
          f"take wgmma_bf16 only")
    # and every RG-LRU layer hands the scan its bf16 gate products with the
    # float32 biases, which the kernel adds itself
    check(rg_routes == {r: launches["rglru_scan"] if r == "fused_bias" else 0
                        for r in rg_routes},
          f"rglru_scan launches by route {rg_routes}: every RG-LRU layer "
          f"must take fused_bias")
    n_tok = sum(len(r.generated) for r in done)
    print(f"  served {len(done)} requests, {n_tok} new tokens in "
          f"{wall:.3f} s ({n_tok / wall:.1f} tok/s); flash_attention "
          f"launches {launches['flash_attention']} = {n_attn} attention "
          f"layers x {n_prefill} prefills; moe_gmm launches "
          f"{launches['moe_gmm']}"
          + (f" = {cfg.n_layers} x ({n_prefill} prefills + {n_decode} "
             f"decode steps)" if want["moe_gmm"] else "")
          + f"; rglru_scan launches {launches['rglru_scan']}"
          + (f" = {n_rglru} RG-LRU layers x {n_prefill} prefills"
             if want["rglru_scan"] else "")
          + f"; mlstm_scan launches {launches['mlstm_scan']}"
          + (f" = {n_mlstm} mLSTM layers x {n_prefill} prefills"
             if want["mlstm_scan"] else "")
          + f"; peak memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"  flash_attention launches by route: {fa_routes}; moe_gmm "
          f"launches by route: {gmm_routes}; rglru_scan launches by route: "
          f"{rg_routes}; mlstm_scan launches by route: {ml_routes}",
          flush=True)
    print(f"  req{done[0].rid}: {done[0].generated}", flush=True)

    # per-step times at the same shapes, through the same step functions
    prefill = make_prefill_step(cfg, cache_len=ctx_len,
                                moe_dispatch=moe_dispatch, device="cuda")
    decode = make_serve_step(cfg, moe_dispatch=moe_dispatch, device="cuda")
    toks = np.stack([r.prompt for r in reqs[:SERVE_SLOTS]])
    with torch.inference_mode():
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(params, {"tokens": toks})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        prefill_ms = sorted(times)[1] * 1e3
        nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        window_note = check_window_cache(cfg, cache, prompt_len, ctx_len)
        for pos in range(prompt_len, ctx_len):
            nxt, logits, cache = decode(params, nxt, pos, cache)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) / GEN * 1e3
        print(f"  prefill {SERVE_SLOTS}x{prompt_len}: {prefill_ms:.2f} ms "
              f"(median of 3); decode: {decode_ms:.3f} ms/step at batch "
              f"{SERVE_SLOTS}, logits {tuple(logits.shape)}{window_note}",
              flush=True)
        # where the time goes: one prefill batch and one decode step
        print_profile(f"prefill {SERVE_SLOTS}x{profile_len}", *profile_ms(
            lambda: prefill(params, {"tokens": toks[:, :profile_len]})))
        print_profile(f"decode step at batch {SERVE_SLOTS}", *profile_ms(
            lambda: decode(params, nxt, ctx_len - 1, cache)))
    return cfg, params, launches, {"flash_attention": fa_routes,
                                   "moe_gmm": gmm_routes,
                                   "rglru_scan": rg_routes,
                                   "mlstm_scan": ml_routes}


def serve_greedy(cfg, params, toks, mesh=None, steps=None,
                 moe_dispatch="einsum", repeats: int = 3, feed=None,
                 extra=None):
    """Prefill ``toks`` (SERVE_SLOTS x PROMPT_LEN) into caches of
    SHARDED_CACHE_LEN slots ``repeats`` times and decode ``steps`` (default
    GEN) greedy steps from the last, through ``make_prefill_step`` /
    ``make_serve_step`` (with ``mesh``, on it); with ``feed`` (greedy
    tokens of another run, (steps + 1, B)), each decode step takes feed's
    token instead of its own; ``extra``: more entries of the prefill's
    batch (a vision model's "patches").  Returns (prefill ms, the median;
    decode ms a step; the greedy tokens (steps + 1, B); the logits,
    prefill's then each step's, float32 on the host; the cache)."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    steps = GEN if steps is None else steps
    prefill = make_prefill_step(cfg, cache_len=SHARDED_CACHE_LEN,
                                moe_dispatch=moe_dispatch, device="cuda",
                                mesh=mesh)
    decode = make_serve_step(cfg, moe_dispatch=moe_dispatch, device="cuda",
                             mesh=mesh)

    def whole(t):
        return t.full_tensor() if mesh is not None else t
    with torch.inference_mode():
        times = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(params, {"tokens": toks, **(extra or {})})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
        tokens, all_logits = [whole(nxt)[:, 0].cpu()], [whole(logits)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, pos in enumerate(range(PROMPT_LEN, PROMPT_LEN + steps)):
            if feed is not None:
                nxt = feed[i][:, None].to(device="cuda", dtype=torch.int32)
            nxt, logits, cache = decode(params, nxt, pos, cache)
            tokens.append(whole(nxt)[:, 0].cpu())
            all_logits.append(whole(logits))
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) / steps * 1e3
    return (sorted(times)[len(times) // 2] * 1e3, decode_ms,
            torch.stack(tokens),
            torch.stack([t.float().cpu() for t in all_logits]),
            cache)


def phase_serve_sharded(cfg, params):
    """Phase 41 (see the module docstring): minicpm-2b's prefill and greedy
    decode on a one-rank mesh beside the same steps without one, then one
    rank's prefill of a (1, SHARDED_TP) mesh on a fake group.  Returns
    (the sharded run's flash launches, {"flash_attention": its launches
    by route})."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import registry as R
    n = min(SHARDED_SERVE_LAYERS, cfg.n_layers)
    cfg = dataclasses.replace(cfg, n_layers=n)
    params = dict(params, layers=params["layers"][:n])
    phase(f"sharded serve {cfg.name} ({cfg.n_layers} layers)")
    rules = sharding.RULESETS["base"]
    axes = R.logical_axes(cfg)
    toks = np.random.default_rng(41).integers(
        1, cfg.vocab_size, size=(SERVE_SLOTS, PROMPT_LEN)).astype(np.int32)
    n_attn = sum(layer_counts(cfg).get(k, 0) for k in ("attn", "swa"))
    fa_route = fa_kernel.ROUTES[torch.bfloat16][1]

    # (a) a one-rank NCCL group, a (1, 1) mesh
    plain = serve_greedy(cfg, params, toks)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_local_mesh(1)
        placed = sharding.distribute_tree(
            params, sharding.logical_to_specs(axes, params, mesh, rules),
            mesh)
        fa_kernel.reset_launches()
        sharded = serve_greedy(cfg, placed, toks, mesh)
        launches = {"flash_attention": fa_kernel.LAUNCHES}
        routes = dict(fa_kernel.LAUNCHES_BY_ROUTE)
        prefill_ms, decode_ms, tokens, logits, cache = sharded
        cache_place = tuple(cache["layers"][0]["k"].placements)
        del placed, sharded, cache
    finally:
        dist.destroy_process_group()
    want = 3 * n_attn
    check(launches["flash_attention"] == want,
          f"sharded serve: flash launched {launches['flash_attention']} "
          f"times, expected {want} = {n_attn} layers x 3 prefills")
    check(routes == {r: want if r == fa_route else 0 for r in routes},
          f"sharded serve: flash launches by route {routes}: bf16 must "
          f"take {fa_route} only")
    check(torch.equal(plain[2], tokens),
          f"sharded serve: greedy tokens differ from the unsharded steps': "
          f"{plain[2].T.tolist()} against {tokens.T.tolist()}")
    err = float((plain[3] - logits).abs().max())
    check(err <= SHARDED_LOGITS_BAR,
          f"sharded serve: logits differ by {err:.3e} > "
          f"{SHARDED_LOGITS_BAR}")
    print(f"  (a) (1, 1) mesh, base ruleset, caches of {SHARDED_CACHE_LEN} "
          f"slots placed {cache_place}: the same {GEN + 1} greedy tokens "
          f"a row as the unsharded steps; logits' largest difference "
          f"{err:.3e} (bar {SHARDED_LOGITS_BAR}; "
          f"{'the same bits' if err == 0 else 'not the same bits'}); "
          f"flash launches {launches['flash_attention']} = {n_attn} layers "
          f"x 3 prefills, by route {routes}", flush=True)
    print(f"  (a) prefill {SERVE_SLOTS}x{PROMPT_LEN}: {prefill_ms:.2f} ms on "
          f"the mesh, {plain[0]:.2f} ms without (median of 3); decode: "
          f"{decode_ms:.3f} ms/step on the mesh, {plain[1]:.3f} without, "
          f"at batch {SERVE_SLOTS} (the difference is DTensor's host cost)",
          flush=True)

    # (b) rank 0 of a (1, SHARDED_TP) mesh of fake ranks on the card
    with fake_group(SHARDED_TP):
        mesh = make_local_mesh(SHARDED_TP, device_type="cuda")
        placed = sharding.distribute_tree(
            params, sharding.logical_to_specs(axes, params, mesh, rules),
            mesh)
        heads = placed["layers"][0]["mix"]["wq"].to_local().shape[1] // \
            cfg.head_dim
        prefill = make_prefill_step(cfg, cache_len=SHARDED_CACHE_LEN,
                                    device="cuda", mesh=mesh)
        with torch.inference_mode():
            prefill(placed, {"tokens": toks})       # the first, untimed
            fa_kernel.reset_launches()
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prefill(placed, {"tokens": toks})
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        rank_launches = fa_kernel.LAUNCHES
        rank_routes = dict(fa_kernel.LAUNCHES_BY_ROUTE)
        del placed
    torch.cuda.empty_cache()
    check(heads * SHARDED_TP == cfg.n_heads,
          f"sharded serve (b): {heads} heads a rank of {cfg.n_heads}")
    check(rank_launches == 3 * n_attn and rank_routes.get(fa_route) ==
          rank_launches, f"sharded serve (b): flash launches "
          f"{rank_routes}, expected {3 * n_attn} on {fa_route}")
    print(f"  (b) one rank of a (1, {SHARDED_TP}) mesh of fake ranks: "
          f"prefill {SERVE_SLOTS}x{PROMPT_LEN} at {heads} of {cfg.n_heads} "
          f"heads a rank {sorted(times)[1] * 1e3:.2f} ms (median of 3; one "
          f"rank's compute with the collectives skipped, its outputs not "
          f"checked); flash launches {rank_launches // 3} a prefill at "
          f"({SERVE_SLOTS}, {PROMPT_LEN}, {heads}, {cfg.head_dim}), by "
          f"route {rank_routes}", flush=True)
    return launches, {"flash_attention": routes}


def check_window_cache(cfg, cache, prompt_len: int, ctx_len: int) -> str:
    """Checks that every windowed layer's cache holds min(window, ctx_len)
    slots; where the prompt passes the window, returns a note that prefill
    ring-rotated it and decode wraps (else "")."""
    windowed = [n for n in range(cfg.n_layers)
                if cfg.block_pattern[n % cfg.pattern_period]
                in ("swa", "local")]
    if not windowed:
        return ""
    slots = {cache["layers"][n]["k"].shape[1] for n in windowed}
    want = min(cfg.window, ctx_len)
    check(slots == {want}, f"windowed layers' caches hold {slots} slots, "
          f"expected {want}")
    if prompt_len <= cfg.window:
        return ""
    return (f"; {len(windowed)} windowed layers' caches of {want} slots: "
            f"prefill of {prompt_len} tokens ring-rotated, decode from "
            f"position {prompt_len} writes slot {prompt_len % want}")


def count_drops(drops: list):
    """Wrap ``moe.moe_gather`` so that each call appends the number of
    (token, expert) pairs its capacity drops, from the same routing
    functions; returns a function that restores it."""
    from repro_torch.models import moe
    real = moe.moe_gather

    def counted(x, p, cfg):
        _, idx, _ = moe.router_topk(x, p["router"], cfg.top_k)
        C = moe._capacity(x.shape[0], cfg.n_experts, cfg.top_k,
                          cfg.capacity_factor)
        drops.append(int((moe._slots(idx.reshape(-1), cfg.n_experts)
                          >= C).sum()))
        return real(x, p, cfg)

    moe.moe_gather = counted

    def restore():
        moe.moe_gather = real
    return restore


def phase_consistency(cfg, params, moe_dispatch: str = "einsum",
                      tol: float = CONSISTENCY_RTOL, n_layers=None,
                      B: int = 2, S: int = 200):
    """prefill + decode_step against forward_logits in float32; the
    negative control decodes at a position off by one, or, in a model with
    no attention layer (it reads no position), feeds each decode step the
    previous token.

    With ``params`` None (the served model freed before) the phase copies
    nothing: it draws its own float32 model at full width, depth cut to
    ``n_layers``, from seed 0 on the card with every norm scale drawn,
    checks the launches and routes of its kernels, and also holds that
    model's forward_logits on the card against the CPU's plain path at
    B 1, S CPU_CHECK_SEQ."""
    from repro_torch.models import registry as R
    from repro_torch.tree import tree_map
    kinds = layer_counts(cfg)
    control = "position" if any(kinds.get(k) for k in ("attn", "swa",
                                                        "local")) else "token"
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    if cfg.is_moe:
        # capacity depends on T, so with drops prefill(S-4) and
        # forward_logits(S) would route different batches.  At this
        # factor C >= T: an expert gets at most one pair per token (top-k
        # experts differ), so no slot reaches C; the run counts the drops.
        cfg32 = dataclasses.replace(
            cfg32, capacity_factor=cfg.n_experts / cfg.top_k)
    if params is None:
        cfg32 = dataclasses.replace(cfg32, n_layers=n_layers)
        phase(f"consistency {cfg.name}, {n_layers} of {cfg.n_layers} layers")
        torch.cuda.empty_cache()
        p32 = R.init_params(cfg32, 0, device="cuda",
                            param_dtype=torch.float32)
        draw_norms(p32)
        print(f"  a float32 model of {n_layers} layers at full width, "
              f"{R.count_params_analytic(cfg32) / 1e9:.3f} B params, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the "
              f"card, norms drawn", flush=True)
    else:
        phase(f"consistency {cfg.name}")
        p32 = {k: ([{g: {n: w.float() for n, w in sub.items()}
                     for g, sub in layer.items()} for layer in v]
                   if k == "layers" else v.float())
               for k, v in params.items()}
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    drops: list = []
    notes: list = []

    def run(shift: int) -> float:
        pos_shift, tok_shift = (shift, 0) if control == "position" else \
            (0, shift)
        with torch.inference_mode():
            full = R.forward_logits(p32, cfg32, {"tokens": toks},
                                    moe_dispatch=moe_dispatch, device="cuda")
            logits, cache = R.prefill(p32, cfg32, {"tokens": toks[:, :S - 4]},
                                      cache_len=S, moe_dispatch=moe_dispatch,
                                      device="cuda")
            if not notes:
                notes.append(check_window_cache(cfg32, cache, S - 4, S))
            err = float((logits - full[:, S - 5]).abs().max())
            for t in range(S - 4, S - 1):
                tok = toks[:, t - tok_shift:t - tok_shift + 1]
                logits, cache = R.decode_step(p32, cfg32, tok,
                                              t + pos_shift, cache,
                                              moe_dispatch=moe_dispatch,
                                              device="cuda")
                err = max(err, float((logits - full[:, t]).abs().max()))
            return err / float(full.abs().max())

    if params is None:
        reset_kernel_launches()
    if cfg.is_moe and moe_dispatch == "gather":
        restore = count_drops(drops)
        try:
            rel = run(0)
        finally:
            restore()
        # forward, prefill and 3 decode steps through every MoE layer
        check(len(drops) == 5 * cfg32.n_layers and not any(drops),
              f"{sum(drops)} pairs dropped in {len(drops)} MoE calls")
        print(f"  capacity factor {cfg32.capacity_factor}: 0 of the "
              f"(token, expert) pairs dropped in {len(drops)} MoE calls",
              flush=True)
    else:
        rel = run(0)
    if params is None:
        # forward and prefill launch flash in every attention layer, the
        # decode steps none; gather's every MoE call moe_gmm; all float32
        launches = kernel_launches()
        n_attn = sum(layer_counts(cfg32).get(k, 0)
                     for k in ("attn", "swa", "local"))
        n_gmm = 5 * cfg32.n_layers if moe_dispatch == "gather" else 0
        check(launches["flash_attention"] == 2 * n_attn and
              launches["moe_gmm"] == n_gmm,
              f"the float32 check launched {launches}, expected "
              f"flash_attention {2 * n_attn}, moe_gmm {n_gmm}")
        check_routes(kernel_routes(), launches,
                     {"flash_attention": "scalar_f32",
                      "moe_gmm": "scalar_f32"}, f"consistency {cfg.name}")
    rel_bad = run(1)
    print(f"  B={B} S={S}: prefill({S - 4}) + 3 decode steps vs "
          f"forward_logits, float32: max rel err {rel:.3e} "
          f"(tol {tol:.0e}); off-by-one {control}: {rel_bad:.3e}"
          f"{notes[0]}", flush=True)
    check(rel <= tol, f"decode disagrees with forward: {rel}")
    check(rel_bad > tol,
          f"an off-by-one {control} passes the tolerance ({rel_bad})")
    if params is not None:
        return
    toks = rng.integers(0, cfg.vocab_size,
                        size=(1, CPU_CHECK_SEQ)).astype(np.int32)
    with torch.inference_mode():
        t0 = time.perf_counter()
        card = R.forward_logits(p32, cfg32, {"tokens": toks},
                                moe_dispatch=moe_dispatch,
                                device="cuda").cpu()
        card_s = time.perf_counter() - t0
        p_cpu = tree_map(lambda t: t.cpu(), p32)
        del p32
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cpu = R.forward_logits(p_cpu, cfg32, {"tokens": toks},
                               moe_dispatch=moe_dispatch, device="cpu")
        cpu_s = time.perf_counter() - t0
    rel_cpu = float((card - cpu).abs().max()) / float(cpu.abs().max())
    print(f"  B=1 S={CPU_CHECK_SEQ}: forward_logits on the card vs the "
          f"CPU's plain path, float32: max rel err {rel_cpu:.3e} (tol "
          f"{tol:.0e}); card {card_s:.2f} s, cpu {cpu_s:.2f} s", flush=True)
    check(rel_cpu <= tol, f"card and cpu disagree: {rel_cpu}")


def phase_zoo():
    """Each of ZOO_ARCHS served (phase_serve), its served model freed,
    then its depth-cut float32 consistency (phase_consistency); returns
    ({arch: launches of each kernel}, {arch: {kernel: launches by
    route}})."""
    from repro_torch.configs import get_arch
    launches, routes = {}, {}
    for arch, n_layers, dispatch, prompt_len in ZOO_ARCHS:
        swa = get_arch(arch).attention == "swa"
        cfg, params, launches[arch], routes[arch] = phase_serve(
            arch, moe_dispatch=dispatch, prompt_len=prompt_len,
            n_layers=n_layers)
        del params
        torch.cuda.empty_cache()
        phase_consistency(cfg, None, moe_dispatch=dispatch,
                          n_layers=ZOO_CONSIST_LAYERS, B=1 if swa else 2,
                          S=SWA_CONSIST_SEQ if swa else 200)
    return launches, routes


def _kernel_modules():
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
    from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
    from repro_torch.kernels.rglru_scan import kernel as rg_kernel
    return fa_kernel, gmm_kernel, rg_kernel, ml_kernel


def kernel_launches() -> dict:
    """Every kernel's launch count, each backward apart."""
    fa, gmm, rg, ml = _kernel_modules()
    return {"flash_attention": fa.LAUNCHES,
            "flash_attention_bwd": fa.BWD_LAUNCHES, "moe_gmm": gmm.LAUNCHES,
            "moe_gmm_bwd": gmm.BWD_LAUNCHES, "rglru_scan": rg.LAUNCHES,
            "rglru_scan_bwd": rg.BWD_LAUNCHES,
            "mlstm_scan": ml.LAUNCHES, "mlstm_scan_bwd": ml.BWD_LAUNCHES}


def kernel_routes() -> dict:
    """Every kernel's launches by route, each backward apart."""
    fa, gmm, rg, ml = _kernel_modules()
    return {"flash_attention": dict(fa.LAUNCHES_BY_ROUTE),
            "flash_attention_bwd": dict(fa.BWD_LAUNCHES_BY_ROUTE),
            "moe_gmm": dict(gmm.LAUNCHES_BY_ROUTE),
            "moe_gmm_bwd": dict(gmm.BWD_LAUNCHES_BY_ROUTE),
            "rglru_scan": dict(rg.LAUNCHES_BY_ROUTE),
            "rglru_scan_bwd": dict(rg.BWD_LAUNCHES_BY_ROUTE),
            "mlstm_scan": dict(ml.LAUNCHES_BY_ROUTE),
            "mlstm_scan_bwd": dict(ml.BWD_LAUNCHES_BY_ROUTE)}


def reset_kernel_launches() -> None:
    for module in _kernel_modules():
        module.reset_launches()


def step_launches(cfg, microbatches: int, backward: bool,
                  moe_dispatch: str = "einsum") -> dict:
    """The launches of one train step (``backward``) or eval step: per
    microbatch and layer a forward, and under full remat its recompute and
    one backward; moe_gmm's only with the gather dispatch (every layer of
    an MoE model has its MoE block)."""
    counts = layer_counts(cfg)
    layers = {"flash_attention": sum(counts.get(k, 0) for k in
                                     ("attn", "swa", "local")),
              "moe_gmm": cfg.n_layers if cfg.is_moe and
              moe_dispatch == "gather" else 0,
              "rglru_scan": counts.get("rglru", 0),
              "mlstm_scan": counts.get("mlstm", 0)}
    want = {k: 0 for k in kernel_launches()}
    for name, n in layers.items():
        if backward:
            want[name] = n * microbatches * (2 if cfg.remat == "full" else 1)
            want[name + "_bwd"] = n * microbatches
        else:
            want[name] = n
    return want


# the route every launch of a bf16 model's train step takes
TRAIN_ROUTES = {"flash_attention": "wgmma_bf16",
                "flash_attention_bwd": "wgmma_bf16", "moe_gmm": "wgmma_bf16",
                "moe_gmm_bwd": "wgmma_bf16",
                "rglru_scan": "fused_bias", "rglru_scan_bwd": "fused_bias",
                "mlstm_scan": "wgmma_bf16", "mlstm_scan_bwd": "wgmma_bf16"}
# the routes of the float32 consistency step
CONSIST_ROUTES = {"flash_attention": "scalar_f32",
                  "flash_attention_bwd": "scalar_f32", "moe_gmm": "scalar_f32",
                  "moe_gmm_bwd": "scalar_f32",
                  "rglru_scan": "fused_bias", "rglru_scan_bwd": "fused_bias",
                  "mlstm_scan": "scalar_f32", "mlstm_scan_bwd": "scalar_f32"}


def check_routes(routes, launches, expected, what):
    for name, want_route in expected.items():
        check(routes[name] == {r: launches[name] if r == want_route else 0
                               for r in routes[name]},
              f"{what}: {name} launches by route {routes[name]}, all "
              f"expected on {want_route}")


def phase_train(arch: str = ARCH, n_layers=None, seq: int = TRAIN_SEQ,
                profile: bool = True, extra=None,
                moe_dispatch: str = "einsum", capacity_factor=None,
                microbatch_nll: bool = False):
    """Four AdamW steps of full-width ``arch`` (``n_layers`` layers, or its
    full depth) at ``seq``, then an eval step, through ``make_train_step``
    / ``make_eval_step``; every flash launch causal unless the model is
    encoder-only; ``extra(cfg, params)`` runs on the trained weights, its
    dict kept under "extra".  An MoE model trains with ``moe_dispatch`` at
    ``capacity_factor`` (None: its config's); after the first step every
    expert of every layer and every router column must hold a non-zero
    first moment, so a gradient lost to the step's zero fill shows, and
    the expert FFN's backward calls are timed by CUDA events.  With
    ``microbatch_nll`` each microbatch's nll is evaluated on the initial
    and on the trained weights (kept under "nll_before" and "nll_after").
    Returns ({kernel: launches over the steps and the eval}, {kernel:
    launches by route}, {step metrics and times})."""
    from repro_torch.configs import get_arch, get_schedule
    from repro_torch.data import batch_for
    from repro_torch.launch.steps import make_eval_step, make_train_step
    from repro_torch.models import registry as R
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = get_arch(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    moe_note = f" moe_dispatch={moe_dispatch} capacity_factor=" \
        f"{cfg.capacity_factor} {cfg.n_layers} layers" if cfg.is_moe else ""
    phase(f"train {arch}{moe_note}")
    check(cfg.remat == "full" and cfg.dtype == "bfloat16",
          f"{cfg.name} trains with remat={cfg.remat} in {cfg.dtype}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # float32 master weights from a seed, cast to bf16 at use
    params = R.init_params(cfg, 0, device="cuda", param_dtype=torch.float32)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    n_params = R.count_params_analytic(cfg)
    shape = ShapeSpec("train", seq, TRAIN_BATCH, "train")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in batch_for(cfg, shape, seed=0, step=0).items()}
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=TRAIN_STEPS,
                       schedule=get_schedule(arch))
    print(f"  {cfg.name}: {cfg.n_layers} layers {layer_counts(cfg)}, "
          f"d={cfg.d_model}, {n_params / 1e9:.3f} B params, float32 weights "
          f"and AdamW moments, {cfg.dtype} compute, remat={cfg.remat}; batch "
          f"{TRAIN_BATCH} x {seq} as {TRAIN_ACCUM} microbatches; "
          f"{ocfg.schedule} lr {ocfg.lr} warmup {ocfg.warmup_steps} of "
          f"{ocfg.total_steps}; init {time.perf_counter() - t0:.2f} s",
          flush=True)
    step_fn = make_train_step(cfg, ocfg, moe_dispatch=moe_dispatch,
                              accum_steps=TRAIN_ACCUM, device="cuda")
    eval_fn = make_eval_step(cfg, moe_dispatch=moe_dispatch, device="cuda")

    def nll_by_microbatch():
        mb = TRAIN_BATCH // TRAIN_ACCUM
        return [float(eval_fn(params, {k: v[j * mb:(j + 1) * mb]
                                       for k, v in batch.items()})["nll"])
                for j in range(TRAIN_ACCUM)]
    nll_before = nll_by_microbatch() if microbatch_nll else None
    want = step_launches(cfg, TRAIN_ACCUM, backward=True,
                         moe_dispatch=moe_dispatch)
    unit = "frames" if cfg.modality == "audio" else "tokens"
    opt_ms, restore_opt = time_adamw()
    bwd_events, restore_bwd = time_expert_bwd()
    reset_kernel_launches()
    masks, restore = record_flash_masks()
    history = []
    if cfg.is_moe:
        routed, restore_routing = record_routing()
    for i in range(TRAIN_STEPS):
        before = kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        m = {k: float(v) for k, v in metrics.items()}
        after = kernel_launches()
        delta = {k: after[k] - before[k] for k in after}
        check(all(math.isfinite(v) for v in m.values()),
              f"train step {i + 1}: a metric is not finite: {m}")
        check(delta == want, f"train step {i + 1} launched {delta}, "
              f"expected {want}")
        m["ms"] = ms
        m["tokens_per_s"] = TRAIN_BATCH * seq / (ms / 1e3)
        m["adamw_ms"] = opt_ms[-1]
        m["expert_bwd_ms"] = sum(a.elapsed_time(b) for a, b in bwd_events)
        bwd_events.clear()
        history.append(m)
        moe_ms = f", {m['expert_bwd_ms']:.1f} in the expert FFN's " \
            f"backward" if cfg.is_moe and moe_dispatch == "gather" else ""
        print(f"  step {i + 1}: loss {m['loss']:.5f} nll {m['nll']:.5f} "
              f"acc {m['acc']:.4f} grad_norm {m['grad_norm']:.4f} lr "
              f"{m['lr']:.3e}; {ms:.1f} ms ({opt_ms[-1]:.1f} in AdamW"
              f"{moe_ms}), {m['tokens_per_s']:.1f} {unit}/s; launches "
              f"{delta}", flush=True)
        if i == 0 and cfg.is_moe:
            restore_routing()
            m["idle_experts"] = check_expert_moments(cfg, params, opt,
                                                     routed)
    restore_opt()
    check(history[-1]["loss"] < history[0]["loss"],
          f"the loss did not fall over {TRAIN_STEPS} steps on one batch: "
          f"{history[0]['loss']} -> {history[-1]['loss']}")
    peak = torch.cuda.max_memory_allocated()
    before = kernel_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = {k: float(v) for k, v in eval_fn(params, batch).items()}
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    delta = {k: v - before[k] for k, v in kernel_launches().items()}
    check(all(math.isfinite(v) for v in ev.values()),
          f"eval: a metric is not finite: {ev}")
    check(delta == step_launches(cfg, TRAIN_ACCUM, backward=False,
                                 moe_dispatch=moe_dispatch),
          f"the eval step launched {delta}")
    restore()
    launches = kernel_launches()
    routes = kernel_routes()
    check_routes(routes, launches, TRAIN_ROUTES, f"train {cfg.name}")
    causal = not cfg.encoder_only
    want_masks = {(name, causal): launches[key] for name, key in
                  (("forward", "flash_attention"),
                   ("backward", "flash_attention_bwd")) if launches[key]}
    check(masks == want_masks, f"train {cfg.name}: flash launches by (pass, "
          f"causal) {masks}, expected {want_masks}")
    # on the weights of the 4 steps (the profiled step below is a 5th)
    nll_after = nll_by_microbatch() if microbatch_nll else None
    steady = [h["ms"] for h in history[1:]]
    print(f"  eval: loss {ev['loss']:.5f} nll {ev['nll']:.5f} acc "
          f"{ev['acc']:.4f}; {eval_ms:.1f} ms; loss {history[0]['loss']:.5f}"
          f" -> {history[-1]['loss']:.5f} over {TRAIN_STEPS} steps",
          flush=True)
    print(f"  {TRAIN_STEPS} steps + eval: launches {launches}; by route "
          f"{routes}; step time {min(steady):.1f}-{max(steady):.1f} ms after "
          f"the first ({history[0]['ms']:.1f} ms); peak memory over the "
          f"steps {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB); flash "
          f"launches by (pass, causal) {masks}", flush=True)
    if profile:
        # where the time goes: one more step, under the profiler
        wall, busy, top, port = profile_ms(
            lambda: step_fn(params, opt, batch))
        print_profile("train step", wall, busy, top, port)
        if bwd_events:
            bwd_ms = sum(a.elapsed_time(b) for a, b in bwd_events)
            print(f"    the expert FFN's backward kernel (CUDA events): "
                  f"{bwd_ms:.3f} ms over {len(bwd_events)} launches, "
                  f"{bwd_ms / busy:.1%} of device busy", flush=True)
    restore_bwd()
    out = {"steps": history, "eval": ev, "eval_ms": eval_ms,
           "peak_bytes": peak}
    if microbatch_nll:
        out["nll_before"], out["nll_after"] = nll_before, nll_after
        print(f"  nll by microbatch: before training "
              f"{[round(v, 5) for v in out['nll_before']]} (mean "
              f"{np.mean(out['nll_before']):.5f}), after {TRAIN_STEPS} steps "
              f"{[round(v, 5) for v in out['nll_after']]} (mean "
              f"{np.mean(out['nll_after']):.5f})", flush=True)
    del opt, batch, step_fn, eval_fn
    torch.cuda.empty_cache()
    if extra is not None:
        out["extra"] = extra(cfg, params)
    del params
    torch.cuda.empty_cache()
    return launches, routes, out


def phase_train_consistency(arch: str = ARCH, n_layers: int = CONSIST_LAYERS,
                            seq: int = CONSIST_SEQ, tol: float = TRAIN_RTOL,
                            moe_dispatch: str = "einsum"):
    """One float32 training step's loss and gradients on the card against
    the same on the CPU, at full width and ``n_layers`` layers, every norm
    scale drawn (0 at init, where a fault in a norm cannot show), with the
    labels shifted by one position (an audio model: its mask flipped) as
    the negative control.  An MoE model runs ``moe_dispatch`` at capacity
    factor E / k, where no (token, expert) pair drops; with the gather
    dispatch the card's einsum step is also held against its gather
    step."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import flatten_with_paths
    from repro_torch.data import batch_for
    from repro_torch.models import registry as R
    from repro_torch.models.config import ShapeSpec
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers,
                              dtype="float32")
    if cfg.is_moe:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    phase(f"train consistency {arch}" + (
        f" moe_dispatch={moe_dispatch}" if cfg.is_moe else ""))
    # drawn on the card (the CPU's generator took tens of seconds for a
    # vocabulary of 256000 x 4096), copied to the CPU for its step
    params = R.init_params(cfg, 0, device="cuda", param_dtype=torch.float32)
    draw_norms(params)
    batch = batch_for(cfg, ShapeSpec("consistency", seq, 1, "train"),
                      seed=1)
    if cfg.modality == "audio":
        control = "the mask flipped"
        bad_batch = dict(batch, mask=1.0 - batch["mask"])
    else:
        control = "labels shifted by one"
        bad_batch = dict(batch, labels=np.roll(batch["labels"], 1, axis=1))

    def run(device, b, dispatch=moe_dispatch):
        p = tree_map(lambda t: t.detach().to(device).requires_grad_(True),
                     params)
        loss, _ = R.forward_train(p, cfg, b, moe_dispatch=dispatch,
                                  device=device)
        loss.backward()
        return float(loss.detach()), {k: t.grad.detach().cpu() for k, t in
                                      flatten_with_paths(p).items()}

    reset_kernel_launches()
    t0 = time.perf_counter()
    masks, restore = record_flash_masks()
    try:
        loss_gpu, g_gpu = run("cuda", batch)
    finally:
        restore()
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launches = kernel_launches()
    want = step_launches(cfg, 1, backward=True, moe_dispatch=moe_dispatch)
    check(launches == want,
          f"the float32 step launched {launches}, expected {want}")
    check_routes(kernel_routes(), launches, CONSIST_ROUTES,
                 f"train consistency {cfg.name}")
    check(all(causal != cfg.encoder_only for _, causal in masks),
          f"train consistency {cfg.name}: flash launches by (pass, causal) "
          f"{masks}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    loss_cpu, g_cpu = run("cpu", batch)
    cpu_s = time.perf_counter() - t0
    # the control on the card: the same step's gradients on a wrong batch
    # (a CPU step of its own took as long as the CPU step above)
    _, g_bad = run("cuda", bad_batch)

    def rel(got, want):
        top = max(float(w.abs().max()) for w in want.values())
        return max(float((got[k] - w).abs().max()) /
                   max(float(w.abs().max()), TRAIN_FLOOR * top)
                   for k, w in want.items())
    err, err_bad = rel(g_gpu, g_cpu), rel(g_gpu, g_bad)
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    print(f"  {cfg.n_layers} layers {layer_counts(cfg)} at full width, "
          f"float32, S={seq}: loss card {loss_gpu:.6f} cpu {loss_cpu:.6f} "
          f"(rel err {loss_err:.3e}); max rel grad err over {len(g_cpu)} "
          f"leaves {err:.3e} (tol {tol:.0e}); {control}: "
          f"{err_bad:.3e}; card {gpu_s:.2f} s, cpu {cpu_s:.2f} s; launches "
          f"{launches}; norms drawn", flush=True)
    check(loss_err <= tol, f"the loss disagrees: {loss_err}")
    check(err <= tol, f"the gradients disagree: {err}")
    check(err_bad > tol, f"{control}: passes the tolerance ({err_bad})")
    out = {"rel_err": err, "shifted_rel_err": err_bad}
    if cfg.is_moe and moe_dispatch == "gather":
        before = kernel_launches()["moe_gmm"]
        loss_ein, g_ein = run("cuda", batch, "einsum")
        check(kernel_launches()["moe_gmm"] == before,
              "the einsum step launched moe_gmm")
        err_ein = rel(g_gpu, g_ein)
        loss_err_ein = abs(loss_gpu - loss_ein) / abs(loss_ein)
        print(f"  card gather against card einsum: loss rel err "
              f"{loss_err_ein:.3e}, max rel grad err {err_ein:.3e} (tol "
              f"{tol:.0e})", flush=True)
        check(loss_err_ein <= tol and err_ein <= tol,
              f"gather and einsum disagree on the card: loss "
              f"{loss_err_ein}, gradients {err_ein}")
        out["einsum_rel_err"] = err_ein
        del g_ein
    del params, g_gpu, g_cpu, g_bad
    return out


def record_flash_masks():
    """Count the flash kernel's launches by (pass, causal) from now on;
    returns (the {("forward" or "backward", causal): launches} dict, a
    function that stops the count)."""
    return record_flash(lambda q, kwargs: bool(kwargs["causal"]))


def record_flash_shapes():
    """Count the flash kernel's launches by (pass, q's (B, S, H, Dh)) from
    now on; returns (the counts, a function that stops the count)."""
    return record_flash(lambda q, kwargs: tuple(q.shape))


def record_flash(what):
    """Count the flash kernel's launches by (pass, ``what(q, kwargs)``)
    from now on, by wrapping ``kernel.launch`` and ``kernel.launch_bwd``
    (which the wrapper and the autograd function call through the
    module); returns (the counts, a function that restores both)."""
    from repro_torch.kernels.flash_attention import kernel
    counts: dict = {}
    real = {"forward": kernel.launch, "backward": kernel.launch_bwd}

    def wrap(name):
        def launch(q, *args, **kwargs):
            key = (name, what(q, kwargs))
            counts[key] = counts.get(key, 0) + 1
            return real[name](q, *args, **kwargs)
        return launch
    kernel.launch, kernel.launch_bwd = wrap("forward"), wrap("backward")

    def restore():
        kernel.launch, kernel.launch_bwd = real["forward"], real["backward"]
    return counts, restore


def record_routing():
    """Count each MoE layer's routed (token, expert) pairs from now on, by
    wrapping ``moe.router_topk`` (both dispatches call it through the
    module), keyed by the router weight's storage; returns ({data_ptr: (E,)
    counts}, a function that restores it)."""
    from repro_torch.models import moe
    real = moe.router_topk
    counts: dict = {}

    def counted(x, wr, k):
        w, idx, aux = real(x, wr, k)
        c = torch.bincount(idx.reshape(-1), minlength=wr.shape[-1])
        key = wr.data_ptr()
        counts[key] = counts[key] + c if key in counts else c
        return w, idx, aux
    moe.router_topk = counted

    def restore():
        moe.router_topk = real
    return counts, restore


def check_expert_moments(cfg, params, opt, routed) -> dict:
    """After the first AdamW step: every layer's expert leaves (w1, w3, w2)
    and router have a non-zero first moment (0.1 of the gradient), which a
    gradient lost to the train step's zero fill would leave at 0; and
    exactly the experts some token was routed to in that step (``routed``,
    from ``record_routing``) have one in each expert leaf, since at random
    init a layer's tokens can all avoid an expert, which then has no
    gradient in either dispatch.  Every router column has one (the aux
    loss reaches each).  Returns {layer: experts no token reached}."""
    idle = {}
    for i, (layer, m) in enumerate(zip(params["layers"], opt.m["layers"])):
        reached = routed[layer["ffn"]["router"].data_ptr()] > 0
        for name in ("w1", "w3", "w2"):
            has = m["ffn"][name].abs().flatten(1).amax(1) > 0
            check(bool(has.any()), f"layer {i} {name}: no gradient")
            check(torch.equal(has, reached),
                  f"layer {i} {name}: experts with a gradient "
                  f"{has.nonzero().flatten().tolist()}, routed to "
                  f"{reached.nonzero().flatten().tolist()}")
        cols = m["ffn"]["router"].abs().amax(0)
        check(bool((cols > 0).all()),
              f"layer {i}: router columns "
              f"{(cols == 0).nonzero().flatten().tolist()} got no gradient")
        if not bool(reached.all()):
            idle[i] = (~reached).nonzero().flatten().tolist()
    print(f"  after step 1: every layer's w1, w3, w2 and router has a "
          f"gradient; exactly the routed experts do ({cfg.n_layers} layers "
          f"x {cfg.n_experts}); experts no token reached, by layer: "
          f"{idle}", flush=True)
    return idle


def time_expert_bwd():
    """Record a pair of CUDA events around each launch of the expert FFN's
    backward kernel from now on (``kernel.launch_bwd``, which the autograd
    function calls through its module); returns (the list of (start, end)
    pairs it appends to, a function that restores it)."""
    from repro_torch.kernels.moe_gmm import kernel
    real = kernel.launch_bwd
    events: list = []

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out
    kernel.launch_bwd = timed

    def restore():
        kernel.launch_bwd = real
    return events, restore


def time_adamw():
    """Time each ``adamw_update`` of the train step from now on (wall
    clock, the card synchronised before and after), by wrapping the name
    ``launch.steps`` calls; returns (the list of ms it appends to, a
    function that restores the name)."""
    from repro_torch.launch import steps
    real = steps.adamw_update
    times: list = []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    steps.adamw_update = timed

    def restore():
        steps.adamw_update = real
    return times, restore


def set_gates(params, gate: float = GATE) -> int:
    """Set every CROSS layer's gate (0 at init) to ``gate``; returns how
    many there are."""
    gates = [lay["mix"]["gate"] for lay in params["layers"]
             if "gate" in lay["mix"]]
    for g in gates:
        g.fill_(gate)
    return len(gates)


def draw_norms(params, seed: int = 1) -> None:
    """Draw every norm scale (0 at init) at 0.1 N(0, 1), so that a norm
    that differs between card and CPU shows (C33)."""
    from repro_torch.convert import flatten_with_paths
    gen = torch.Generator().manual_seed(seed)
    for name, t in flatten_with_paths(params).items():
        if name.endswith("ln']"):
            t.copy_(0.1 * torch.randn(t.shape, generator=gen))


def cross_attention_ms(cfg, params, patches, prefill_ms):
    """CUDA-event times of one CROSS block (``transformer._cross_attn``)
    and of its plain attention alone at the serving prefill's shapes, and
    the bound of that attention (S_k = n_patches keys for every query,
    4 Dh FLOPs a pair at the bf16 rate; q, k, v read and o written once);
    their shares of the prefill are the block's times n_cross over
    ``prefill_ms``."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import attention, dense, rms_norm
    n_cross = sum(T.layer_kind(cfg, n) == "cross"
                  for n in range(cfg.n_layers))
    p = next(lay["mix"] for lay in params["layers"] if "gate" in lay["mix"])
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(5)
    B, S, P = SERVE_SLOTS, PROMPT_LEN, patches.shape[1]
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    with torch.inference_mode():
        x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda",
                        dtype=dt)
        memory = dense(torch.as_tensor(patches, device="cuda").to(dt),
                       params["vis_proj"])
        block_ms = cuda_ms(lambda: T._cross_attn(x, p, cfg, memory=memory),
                           iters=10)
        q = dense(rms_norm(x, p["ln"], cfg.norm_eps), p["wq"]) \
            .reshape(B, S, H, Dh)
        k = dense(memory, p["wk"]).reshape(B, P, KH, Dh)
        v = dense(memory, p["wv"]).reshape(B, P, KH, Dh)
        attn_ms = cuda_ms(lambda: attention(q, k, v, causal=False),
                          iters=10)
    flops = 4.0 * B * H * Dh * S * P
    nbytes = 2 * (2 * B * S * H * Dh + 2 * B * P * KH * Dh)
    bound_ms = max(flops / PEAK_FLOPS[dt], nbytes / HBM_BW) * 1e3
    print(f"  cross-attention at B={B} S_q={S} S_k={P} H={H} KH={KH} "
          f"Dh={Dh} (CUDA events): the block {block_ms:.4f} ms, its plain "
          f"attention {attn_ms:.4f} ms (bound {bound_ms:.4f} ms, "
          f"{flops / 1e9:.2f} GFLOP); x {n_cross} CROSS layers: block "
          f"{n_cross * block_ms:.2f} ms ({n_cross * block_ms / prefill_ms:.1%}"
          f" of the prefill), attention {n_cross * attn_ms:.2f} ms "
          f"({n_cross * attn_ms / prefill_ms:.1%})", flush=True)
    return {"block_ms": block_ms, "attention_ms": attn_ms,
            "bound_ms": bound_ms, "n_cross": n_cross,
            "share_of_prefill": n_cross * block_ms / prefill_ms}


def phase_serve_vision(arch: str = VISION_ARCH):
    """Serve SERVE_REQUESTS requests of the vision model at full width
    and depth, SERVE_SLOTS at a time, through ``make_prefill_step`` (with
    each batch's patches) and ``make_serve_step``: the first new token
    from the prefill, GEN - 1 from decode steps.  Every prefill must
    launch the flash kernel once per ATTN layer, causal, on its wgmma
    route, and no decode step any; the CROSS layers compute on plain
    PyTorch.  Returns (cfg, params, launches, {kernel: launches by route},
    the serve's numbers); the caller drops the params."""
    from repro_torch.configs import get_arch
    from repro_torch.data.frontends import vision_patches
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import registry as R
    phase(f"serve {arch}")
    cfg = get_arch(arch)
    t0 = time.perf_counter()
    params = R.init_params(cfg, 0, device="cuda")
    n_cross = set_gates(params)
    torch.cuda.synchronize()
    n_params = R.count_params_analytic(cfg)
    kinds = layer_counts(cfg)
    n_attn = kinds.get("attn", 0)
    print(f"  {cfg.name}: {cfg.n_layers} layers {kinds}, d={cfg.d_model}, "
          f"GQA {cfg.n_heads}/{cfg.n_kv_heads} at Dh {cfg.head_dim}, "
          f"{n_params / 1e9:.3f} B params in {cfg.dtype}, init "
          f"{time.perf_counter() - t0:.2f} s; {n_cross} gates set to "
          f"{GATE}; {cfg.n_patches} patches of {cfg.frontend_dim} a row",
          flush=True)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab_size, size=(
        SERVE_REQUESTS, PROMPT_LEN)).astype(np.int32)
    n_batches = math.ceil(SERVE_REQUESTS / SERVE_SLOTS)
    # each batch's images, from its own seed
    patches = [vision_patches(SERVE_SLOTS, cfg.n_patches, cfg.frontend_dim,
                              seed=i) for i in range(n_batches)]
    ctx_len = PROMPT_LEN + GEN
    prefill = make_prefill_step(cfg, cache_len=ctx_len, device="cuda")
    decode = make_serve_step(cfg, device="cuda")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    masks, restore = record_flash_masks()
    generated = []
    try:
        t0 = time.perf_counter()
        with torch.inference_mode():
            for i in range(n_batches):
                toks = prompts[i * SERVE_SLOTS:(i + 1) * SERVE_SLOTS]
                before = fa_kernel.LAUNCHES
                logits, cache = prefill(params, {"tokens": toks,
                                                 "patches": patches[i]})
                check(fa_kernel.LAUNCHES - before == n_attn,
                      f"prefill {i} launched the flash kernel "
                      f"{fa_kernel.LAUNCHES - before} times, expected "
                      f"{n_attn}")
                check(bool(torch.isfinite(logits).all()),
                      f"prefill {i}: logits not finite")
                nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
                out = [nxt]
                before = fa_kernel.LAUNCHES
                for pos in range(PROMPT_LEN, PROMPT_LEN + GEN - 1):
                    nxt, logits, cache = decode(params, nxt, pos, cache)
                    out.append(nxt)
                check(fa_kernel.LAUNCHES == before,
                      f"decode of batch {i} launched the flash kernel")
                check(bool(torch.isfinite(logits).all()),
                      f"decode of batch {i}: logits not finite")
                generated.append(torch.cat(out, dim=1).cpu())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated()
    launches, routes = kernel_launches(), kernel_routes()
    tokens = torch.cat(generated)
    check(tuple(tokens.shape) == (SERVE_REQUESTS, GEN),
          f"generated {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "a token outside the vocab")
    want = {k: 0 for k in launches}
    want["flash_attention"] = n_attn * n_batches
    check(launches == want, f"the serve launched {launches}, expected {want}")
    check(masks == {("forward", True): n_attn * n_batches},
          f"flash launches by (pass, causal) {masks}: every one causal")
    check_routes(routes, launches, {"flash_attention": "wgmma_bf16"},
                 f"serve {cfg.name}")
    n_tok = SERVE_REQUESTS * GEN
    print(f"  served {SERVE_REQUESTS} requests in {n_batches} batches of "
          f"{SERVE_SLOTS}, {n_tok} new tokens in {wall:.3f} s "
          f"({n_tok / wall:.1f} tok/s); flash_attention launches "
          f"{launches['flash_attention']} = {n_attn} ATTN layers x "
          f"{n_batches} prefills, all causal on wgmma_bf16, none in decode; "
          f"peak memory {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB)",
          flush=True)
    print(f"  req0: {tokens[0].tolist()}", flush=True)

    batch = {"tokens": prompts[:SERVE_SLOTS], "patches": patches[0]}
    with torch.inference_mode():
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(params, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        prefill_ms = sorted(times)[1] * 1e3
        nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(PROMPT_LEN, ctx_len):
            nxt, logits, cache = decode(params, nxt, pos, cache)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) / GEN * 1e3
        print(f"  prefill {SERVE_SLOTS}x{PROMPT_LEN} with {cfg.n_patches} "
              f"patches a row: {prefill_ms:.2f} ms (median of 3); decode: "
              f"{decode_ms:.3f} ms/step at batch {SERVE_SLOTS}", flush=True)
        print_profile(f"prefill {SERVE_SLOTS}x{PROMPT_LEN}", *profile_ms(
            lambda: prefill(params, batch)))
        print_profile(f"decode step at batch {SERVE_SLOTS}", *profile_ms(
            lambda: decode(params, nxt, ctx_len - 1, cache)))
        del cache
    cross = cross_attention_ms(cfg, params, patches[0], prefill_ms)
    return cfg, params, launches, routes, {
        "prefill_ms": prefill_ms, "decode_ms": decode_ms,
        "tokens_per_s": n_tok / wall, "peak_bytes": peak, "cross": cross}


def phase_consistency_vision(arch: str = VISION_ARCH,
                             n_layers: int = VISION_CONSIST_LAYERS,
                             seq: int = VISION_CONSIST_SEQ):
    """Prefill of ``seq`` - 4 tokens with their image, then 3 decode
    steps, in float32 at full width and ``n_layers`` layers: the logits on
    the card (flash's scalar_f32 route, cuBLAS) against the CPU's plain
    versions from the same weights, every gate at GATE and every norm
    drawn; the negative control feeds the card another image's patches."""
    from repro_torch.configs import get_arch
    from repro_torch.data import batch_for
    from repro_torch.data.frontends import vision_patches
    from repro_torch.models import registry as R
    from repro_torch.models.config import ShapeSpec
    from repro_torch.tree import tree_map
    phase(f"consistency {arch}")
    cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers,
                              dtype="float32")
    # drawn on the card (fast), then copied to the CPU
    params = R.init_params(cfg, 0, device="cuda", param_dtype=torch.float32)
    set_gates(params)
    p_cpu = tree_map(lambda t: t.cpu(), params)
    draw_norms(p_cpu)
    params = tree_map(lambda t: t.cuda(), p_cpu)
    batch = batch_for(cfg, ShapeSpec("consistency", seq, 1, "train"),
                      seed=1)
    toks = batch["tokens"]
    other = vision_patches(1, cfg.n_patches, cfg.frontend_dim, seed=99)

    def run(device, p, patches):
        with torch.inference_mode():
            logits, cache = R.prefill(p, cfg, {"tokens": toks[:, :seq - 4],
                                               "patches": patches},
                                      cache_len=seq, device=device)
            out = [logits.cpu()]
            for t in range(seq - 4, seq - 1):
                logits, cache = R.decode_step(p, cfg, toks[:, t:t + 1], t,
                                              cache, device=device)
                out.append(logits.cpu())
        return torch.stack(out)

    reset_kernel_launches()
    t0 = time.perf_counter()
    card = run("cuda", params, batch["patches"])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = kernel_launches()
    n_attn = layer_counts(cfg).get("attn", 0)
    check(launches["flash_attention"] == n_attn,
          f"the float32 prefill launched {launches}")
    check_routes(kernel_routes(), launches,
                 {"flash_attention": "scalar_f32"}, f"consistency {arch}")
    bad = run("cuda", params, other)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu = run("cpu", p_cpu, batch["patches"])
    cpu_s = time.perf_counter() - t0
    scale = float(cpu.abs().max())
    rel = float((card - cpu).abs().max()) / scale
    rel_bad = float((bad - cpu).abs().max()) / scale
    print(f"  {n_layers} layers {layer_counts(cfg)} at full width, float32, "
          f"gates {GATE}, norms drawn: prefill({seq - 4}) + 3 decode steps "
          f"with {cfg.n_patches} patches, card vs cpu max rel err "
          f"{rel:.3e} (tol {CONSISTENCY_RTOL:.0e}); another image's patches "
          f"on the card: {rel_bad:.3e}; card {card_s:.2f} s, cpu "
          f"{cpu_s:.2f} s", flush=True)
    check(rel <= CONSISTENCY_RTOL, f"card and cpu disagree: {rel}")
    check(rel_bad > CONSISTENCY_RTOL,
          f"another image's patches pass the tolerance ({rel_bad})")
    return {"rel_err": rel, "other_patches_rel_err": rel_bad}


def time_encode(cfg, params):
    """One ``forward_logits`` encode of ENCODE_BATCH x TRAIN_SEQ frames
    under ``inference_mode``, on bf16 copies of the trained weights (what
    an encoder serves from): the median of 3 calls, each launching the
    flash kernel once a layer, not causal."""
    from repro_torch.data import batch_for
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import registry as R
    from repro_torch.models.config import ShapeSpec
    from repro_torch.tree import tree_map
    batch = batch_for(cfg, ShapeSpec("encode", TRAIN_SEQ, ENCODE_BATCH,
                                     "train"), seed=2)
    frames = {"frames": torch.as_tensor(batch["frames"], device="cuda")}
    p16 = tree_map(lambda t: t.detach().to(torch.bfloat16), params)
    masks, restore = record_flash_masks()
    times = []
    try:
        with torch.inference_mode():
            for _ in range(3):
                before = fa_kernel.LAUNCHES
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = R.forward_logits(p16, cfg, frames, device="cuda")
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                check(fa_kernel.LAUNCHES - before == cfg.n_layers,
                      f"the encode launched flash "
                      f"{fa_kernel.LAUNCHES - before} times")
    finally:
        restore()
    check(masks == {("forward", False): 3 * cfg.n_layers},
          f"encode flash launches by (pass, causal) {masks}")
    check(tuple(out.shape) == (ENCODE_BATCH, TRAIN_SEQ, cfg.vocab_size)
          and bool(torch.isfinite(out).all()),
          f"encode output {tuple(out.shape)} not finite or misshapen")
    ms = sorted(times)[1] * 1e3
    print(f"  encode (forward_logits, inference_mode, bf16 weights) "
          f"{ENCODE_BATCH} x {TRAIN_SEQ} frames: {ms:.2f} ms (median of "
          f"3), {ENCODE_BATCH * TRAIN_SEQ / (ms / 1e3):.0f} frames/s; "
          f"{cfg.n_layers} flash launches a call, not causal", flush=True)
    del p16, out
    return {"encode_ms": ms}


# granite-moe's training: both dispatches at equal depth, then the gather
# dispatch at full depth
MOE_TRAIN_LAYERS = 4
# gather against einsum, step by step, relative to einsum's loss: from one
# init at capacity factor E / k (no pair drops) the two compute the same
# function, in bf16 with other roundings (other bucket shapes, h rounded
# to bf16 in the kernel, another combine order) and router near-ties
# (C15); `python3 tools/moe_dispatch_cpu.py` (granite's routing at d 256,
# 2 layers, bf16, on the CPU) puts the two within 2e-4 of the loss over
# four steps, and the same run with the experts' gradients dropped 4-6%
# apart at steps 2-4: 1e-2 sits between the two
MOE_DISPATCH_RTOL = 1e-2
# the float32 train step of granite-moe (2 layers, S 512) on the card,
# gather against the CPU's plain step and against einsum on the card
MOE_CONSIST_LAYERS, MOE_CONSIST_SEQ, MOE_TRAIN_RTOL = 2, 512, 2e-5


def phase_train_moe_dispatches():
    """Phase 22: granite-moe at full width, MOE_TRAIN_LAYERS layers, as
    phase 12, gather and einsum from one init at capacity factor E / k:
    their losses within MOE_DISPATCH_RTOL step by step, both falling."""
    from repro_torch.configs import get_arch
    cfg = get_arch(MOE_ARCH)
    cf = cfg.n_experts / cfg.top_k
    runs = {d: phase_train(MOE_ARCH, MOE_TRAIN_LAYERS, moe_dispatch=d,
                           capacity_factor=cf, profile=False)
            for d in ("gather", "einsum")}
    curves = {d: [(h["loss"], h["nll"]) for h in out["steps"]]
              for d, (_, _, out) in runs.items()}
    rels = [abs(g[0] - e[0]) / abs(e[0])
            for g, e in zip(curves["gather"], curves["einsum"])]
    print(f"  {MOE_TRAIN_LAYERS} layers, capacity factor {cf}: (loss, nll) "
          f"a step, gather {curves['gather']}, einsum {curves['einsum']}; "
          f"loss rel diff a step {[f'{r:.2e}' for r in rels]} (tol "
          f"{MOE_DISPATCH_RTOL:.0e})", flush=True)
    check(all(r <= MOE_DISPATCH_RTOL for r in rels),
          f"gather and einsum losses differ: {rels}")
    return runs["gather"], curves


def phase_train_moe_full():
    """Phase 23: granite-moe at full width and depth through the gather
    dispatch at its config's capacity factor, each microbatch's nll
    evaluated before and after the steps; then the einsum dispatch from
    the same init, the same way, for comparison.  The gather run's loss
    and its batch nll (the mean over both microbatches) must fall.  The
    last microbatch's nll is printed and not checked: at full depth this
    recipe fits the first microbatch (-2 nats over the 3 updates) at the
    second's expense on both dispatches, so it rises there whichever
    dispatch computes the step (PERF.md)."""
    launches, routes, out = phase_train(MOE_ARCH, moe_dispatch="gather",
                                        microbatch_nll=True)
    before, after = np.mean(out["nll_before"]), np.mean(out["nll_after"])
    check(after < before,
          f"granite-moe gather: the batch nll did not fall over "
          f"{TRAIN_STEPS} steps: {before} -> {after}")
    _, _, einsum = phase_train(MOE_ARCH, moe_dispatch="einsum",
                               profile=False, microbatch_nll=True)
    def curve(steps):
        return [(round(h["loss"], 5), round(h["nll"], 5)) for h in steps]
    print(f"  full depth, (loss, last microbatch's nll) a step: gather "
          f"{curve(out['steps'])}, einsum {curve(einsum['steps'])}",
          flush=True)
    return launches, routes, out


# the §5 pipeline at a size where a count step does real work: 8 samples of
# 64 rows of 1024 tokens, tiny_lm at d_model 1024 (4 heads of 256, so the
# flash kernel pads nothing) and a 32768-token vocabulary, 16 steps of 8 rows
PIPELINE_REAL = dict(n_samples=8, rows_per_sample=64, seq_len=1024,
                     train_steps=16, batch=8, vocab=32768, d_model=1024)
PIPELINE_KINDS = ("mkfastq", "count", "seurat", "singler", "aggregate")


def phase_pipeline(label: str, doc):
    """Phase 25: the port's §5 step bodies in the engine's order (every
    sample's count, then seurat, then singler, then the aggregate),
    each tool made by its factory from the declarative document's
    arguments as the engine makes it.  Per step kind: seconds, flash
    launches (a count invocation 2 forward and 2 backward a train step:
    2 layers, remat "none"; a seurat invocation 2 forward) and the
    device-busy share of one profiled invocation."""
    from repro_torch import pipeline
    phase(f"pipeline {label}")
    tools = doc["tools"]
    steps = doc["workflows"]["single-cell-scatter"]["steps"]
    n = steps["/mkfastq"]["streams"]["shard"]
    train_steps = tools["count"]["implementation"]["args"]["train_steps"]
    fns = {kind: getattr(pipeline, tools[kind]["implementation"]["factory"])(
        **tools[kind]["implementation"].get("args", {}))
        for kind in PIPELINE_KINDS}
    want = {"count": {"flash_attention": 2 * train_steps,
                      "flash_attention_bwd": 2 * train_steps},
            "seurat": {"flash_attention": 2, "flash_attention_bwd": 0}}
    seconds = {kind: 0.0 for kind in PIPELINE_KINDS}
    launches = {kind: {"flash_attention": 0, "flash_attention_bwd": 0}
                for kind in PIPELINE_KINDS}
    reset_kernel_launches()

    def call(kind, inputs, tag=None):
        before = kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fns[kind](inputs, {} if tag is None else {"tag": (tag,)})
        torch.cuda.synchronize()
        seconds[kind] += time.perf_counter() - t0
        after = kernel_launches()
        delta = {k: after[k] - before[k] for k in after}
        for k in launches[kind]:
            launches[kind][k] += delta[k]
        expect = {k: want.get(kind, {}).get(k, 0) for k in delta}
        check(delta == expect, f"pipeline {kind} invocation {tag}: "
              f"launched {delta}, expected {expect}")
        return out

    shards = call("mkfastq", {"seed": 0})["shard"]
    counted = [call("count", {"shard": shards[i]}, i) for i in range(n)]
    clusters = [call("seurat", {"shard": shards[i],
                                "model": counted[i]["model"]}, i)
                for i in range(n)]
    labels = [call("singler", {"clusters": c["clusters"]}, i)
              for i, c in enumerate(clusters)]
    summary = call("aggregate", {"labels": [lab["labels"]
                                            for lab in labels]})["summary"]
    check_routes(kernel_routes(), kernel_launches(), TRAIN_ROUTES,
                 f"pipeline {label}")
    losses = [c["stats"]["losses"] for c in counted]
    check(all(len(ls) == train_steps and all(map(math.isfinite, ls))
              for ls in losses), f"pipeline {label}: count losses {losses}")
    n_clusters = len(clusters[0]["clusters"]["centroids"])
    check(summary["n_samples"] == n and
          int(summary["type_counts"].sum()) == n * n_clusters and
          math.isfinite(summary["mean_confidence"]),
          f"pipeline {label}: the summary {summary} does not cover the "
          f"{n} samples")
    busy = {}
    for kind, inputs in (("count", {"shard": shards[0]}),
                         ("seurat", {"shard": shards[0],
                                     "model": counted[0]["model"]})):
        wall, dev, _, _ = profile_ms(lambda: fns[kind](inputs,
                                                       {"tag": (0,)}))
        busy[kind] = dev / wall if wall > 0 else float("nan")
    rows, seq = shards[0].shape[0], shards[0].shape[1] - 1
    print(f"  {n} samples of {rows} x {seq} tokens; count {train_steps} "
          f"steps each; summary: {n} samples, type counts "
          f"{summary['type_counts'].tolist()}, mean confidence "
          f"{summary['mean_confidence']:.4f}; count losses, first sample "
          f"{[round(v, 5) for v in losses[0]]}", flush=True)
    for kind in PIPELINE_KINDS:
        share = f", device busy {busy[kind]:.1%} of one profiled " \
            f"invocation" if kind in busy else ""
        calls = 1 if kind in ("mkfastq", "aggregate") else n
        print(f"  {kind:9s}: {seconds[kind]:.3f} s over {calls} "
              f"invocations ({seconds[kind] / calls * 1e3:.1f} ms each); "
              f"flash launches {launches[kind]}{share}", flush=True)
    return {"seconds": seconds, "launches": launches, "busy": busy,
            "losses": losses, "summary": summary,
            "assign": [c["clusters"]["assign"] for c in clusters],
            "models": [c["model"] for c in counted]}


# phase 26: one sample's count and seurat in float32, card against CPU,
# from one init, at d_model 256 (4 heads of 64, flash's scalar_f32 route)
PIPE_CONSIST = dict(vocab=4096, d_model=256, rows=16, seq=256, steps=4,
                    batch=4, chain=1)
# the per-step losses: float32 sums in other orders, and AdamW, which
# moves an element by ~lr whatever its gradient's size, over 4 steps:
# ~1e-6 apart; TRAIN_RTOL is the bar.  The embeddings (mean logits of the
# trained weights) relative to their max |.|: the weights differ by at most
# ~1e-2 lr where a gradient is of rounding size, ~1e-5 of the embeddings;
# training moves them by ~1e-2 (the untrained init's embeddings, the
# control), so 1e-3
PIPE_EMBED_RTOL = 1e-3


def phase_pipeline_consistency():
    from repro_torch import pipeline
    from repro_torch.convert import params_to_jax
    from repro_torch.tree import tree_map
    phase("pipeline consistency")
    c = PIPE_CONSIST
    cfg = dataclasses.replace(pipeline.tiny_lm(vocab=c["vocab"],
                                               d_model=c["d_model"]),
                              dtype="float32")
    shard = pipeline.mkfastq_tool(1, c["rows"], c["seq"], c["vocab"])(
        {"seed": 3}, {})["shard"][0]
    init = pipeline.init_model(cfg, c["chain"], "cpu")
    def run(dev, steps=c["steps"]):
        """(per-step losses, seurat's clusters) of count and seurat on
        ``dev`` from the init."""
        params = tree_map(lambda t: t.clone().to(dev), init)
        params, losses = pipeline.train_shard(params, shard, cfg, steps,
                                              c["batch"], dev)
        seurat = pipeline._seurat_fn(c["chain"], cfg, device=dev)
        return losses, seurat({"shard": shard,
                               "model": params_to_jax(cfg, params)},
                              {})[f"clusters{c['chain']}"]

    reset_kernel_launches()
    l_gpu, cl_gpu = run("cuda")
    want = {k: 0 for k in kernel_launches()}
    want.update(flash_attention=2 * c["steps"] + 2,
                flash_attention_bwd=2 * c["steps"])
    check(kernel_launches() == want,
          f"pipeline consistency: launched {kernel_launches()}")
    check_routes(kernel_routes(), kernel_launches(), CONSIST_ROUTES,
                 "pipeline consistency")
    l_cpu, cl_cpu = run("cpu")
    _, untrained = run("cpu", steps=0)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    scale = float(np.abs(cl_cpu["embeddings"]).max())
    emb_err = float(np.abs(cl_gpu["embeddings"] -
                           cl_cpu["embeddings"]).max()) / scale
    emb_ctl = float(np.abs(cl_gpu["embeddings"] -
                           untrained["embeddings"]).max()) / scale
    same = bool(np.array_equal(cl_gpu["assign"], cl_cpu["assign"]))
    print(f"  tiny_lm d_model {c['d_model']} vocab {c['vocab']}, float32, "
          f"{c['rows']} rows of {c['seq']} tokens, {c['steps']} steps of "
          f"{c['batch']}: losses card {[round(v, 6) for v in l_gpu]} cpu "
          f"{[round(v, 6) for v in l_cpu]} (max rel err {loss_err:.3e}, "
          f"tol {TRAIN_RTOL:.0e}); embeddings max rel err {emb_err:.3e} "
          f"(tol {PIPE_EMBED_RTOL:.0e}), against the untrained model's "
          f"{emb_ctl:.3e}; cluster assignments equal: {same} "
          f"{cl_gpu['assign'].tolist()}", flush=True)
    check(loss_err <= TRAIN_RTOL, f"the count losses disagree: {loss_err}")
    check(emb_err <= PIPE_EMBED_RTOL, f"the embeddings disagree: {emb_err}")
    check(emb_ctl > PIPE_EMBED_RTOL,
          f"the untrained model's embeddings pass the tolerance ({emb_ctl})")
    check(same, "the cluster assignments differ")
    check(l_gpu[-1] < l_gpu[0], f"the count loss did not fall: {l_gpu}")
    return {"loss_rel_err": loss_err, "embed_rel_err": emb_err,
            "untrained_embed_rel_err": emb_ctl}


# phase 38: the §5 workflow through the port's StreamFlow engine, held to
# phase 25's hand-ordered run from the same seed.  Each invocation runs the
# same ops on the same inputs in the same order as there; the engine's
# threads interleave invocations on the one stream but share no tensor, and
# every op on the path is deterministic (the flash kernels by design, bit
# for bit on a repeat in phase 3; GEMMs, the embedding's backward and the
# loss's reductions on the card), so the bits are expected equal.  The bars
# bound the report should an op reorder a float32 sum: the count losses
# within TRAIN_RTOL, the mean confidence within ENGINE_CONF_ATOL, every
# leaf of every count model within ENGINE_PARAM_ATOL (float32 masters of
# scale ~2e-2); cluster assignments and type counts must be equal
ENGINE_CONF_ATOL = 1e-6
ENGINE_PARAM_ATOL = 1e-5


@contextlib.contextmanager
def recorded_tools(module, factories):
    """Wrap each named tool factory of ``module`` so that the step bodies
    it makes record their outputs by scatter tag ({factory: {tag:
    outputs}}), returned unchanged; the engine imports the factory by name
    when it loads a document."""
    seen = {name: {} for name in factories}
    lock = threading.Lock()
    real = {name: getattr(module, name) for name in factories}

    def wrap(name):
        @functools.wraps(real[name])
        def factory(*args, **kwargs):
            body = real[name](*args, **kwargs)

            def run(inputs, ctx):
                out = body(inputs, ctx)
                with lock:
                    seen[name][ctx.get("tag", (0,))[0]] = out
                return out
            return run
        return factory

    for name in factories:
        setattr(module, name, wrap(name))
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(module, name, fn)


def run_engine(doc):
    """The entry points a user calls: load the document, build the
    executor from it, run its workflow from seed 0.  (executor, result)."""
    from repro_torch.core import (FaultConfig, StreamFlowExecutor,
                                  load_streamflow_file)
    cfg = load_streamflow_file(doc)
    entry = cfg.workflows["single-cell-scatter"]
    ex = StreamFlowExecutor.from_config(
        cfg, fault=FaultConfig(speculative=False))
    res = ex.run(entry.workflow, entry.bindings, inputs={"seed": 0})
    torch.cuda.synchronize()
    return ex, res


def transfer_links(res) -> dict:
    """{(kind, source site, target site): [transfers, bytes]}."""
    links = {}
    for t in res.transfers:
        key = (t.kind, None if t.src is None else t.src.split(":")[0],
               t.dst.split(":")[0])
        n, b = links.get(key, (0, 0))
        links[key] = (n + 1, b + t.bytes)
    return links


def leaf_diffs(got, want) -> list:
    """max |got - want| of each leaf of two models in the JAX layout."""
    from repro_torch.convert import flatten_with_paths
    g, w = flatten_with_paths(got), flatten_with_paths(want)
    check(sorted(g) == sorted(w), f"model leaves {sorted(g)} != {sorted(w)}")
    return [0.0 if np.array_equal(g[k], w[k]) else
            float(np.abs(np.asarray(g[k], np.float64) -
                         np.asarray(w[k], np.float64)).max()) for k in w]


def least_invocation_seconds(events) -> dict:
    """{declared step: the least seconds of its completed invocations}:
    per-step costs that overestimate nothing (benchmarks/bench_analyze.py's
    calibration)."""
    least = {}
    for e in events:
        if e.status == "completed":
            step = e.step.split("@")[0]
            least[step] = min(least.get(step, math.inf), e.end - e.start)
    return least


def phase_pipeline_engine(label: str, doc, hand: dict, profile: bool):
    """Phase 38: ``doc`` through ``repro_torch.core`` (load, executor,
    run), against phase 25's run of the same document (``hand``)."""
    from repro_torch import pipeline
    phase(f"pipeline engine {label}")
    steps = doc["workflows"]["single-cell-scatter"]["steps"]
    n = steps["/mkfastq"]["streams"]["shard"]
    train_steps = doc["tools"]["count"]["implementation"]["args"][
        "train_steps"]
    reset_kernel_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with recorded_tools(pipeline, ("count_tool", "seurat_tool")) as seen:
        ex, res = run_engine(doc)
    peak = torch.cuda.max_memory_allocated()
    launches, routes = kernel_launches(), kernel_routes()
    want = {k: 0 for k in launches}
    want.update(flash_attention=n * (2 * train_steps + 2),
                flash_attention_bwd=n * 2 * train_steps)
    check(launches == want, f"pipeline engine {label}: launched {launches}, "
          f"expected {want}")
    check_routes(routes, launches, TRAIN_ROUTES, f"pipeline engine {label}")

    # where the work ran: every invocation once, done at attempt 0
    kinds = {}
    for e in res.events:
        kinds.setdefault(e.step.split("@")[0], []).append(e)
    check({k: len(v) for k, v in kinds.items()} ==
          {"/mkfastq": 1, "/count": n, "/seurat": n, "/singler": n,
           "/aggregate": 1}, f"pipeline engine {label}: invocations "
          f"{ {k: len(v) for k, v in kinds.items()} }")
    bad = [(e.step, e.status, e.attempt, e.speculative) for e in res.events
           if e.status != "completed" or e.attempt != 0 or e.speculative]
    check(not bad, f"pipeline engine {label}: retried, speculative or "
          f"unfinished invocations {bad}")
    for kind in ("/count", "/seurat"):
        placed = sorted((int(e.step.split("@")[1]), e.resource)
                        for e in kinds[kind])
        print(f"  {kind[1:]} invocations: " + ", ".join(
            f"{i} on {resource}" for i, resource in placed), flush=True)
    t0 = min(e.start for e in res.events)
    print("  timeline (s from the first start: first start - last end, "
          "summed invocation seconds): " + "; ".join(
              f"{kind[1:]} {min(e.start for e in evs) - t0:.3f} - "
              f"{max(e.end for e in evs) - t0:.3f}, "
              f"{sum(e.end - e.start for e in evs):.3f}"
              for kind, evs in kinds.items()), flush=True)

    # the same result as phase 25
    summary = res.outputs["summary"]
    losses = [s["losses"] for s in res.outputs["stats"]]
    check(summary["n_samples"] == n and len(losses) == n,
          f"pipeline engine {label}: the summary {summary} or the "
          f"{len(losses)} stats do not cover the {n} samples")
    check(np.array_equal(summary["type_counts"],
                         hand["summary"]["type_counts"]),
          f"pipeline engine {label}: type counts "
          f"{summary['type_counts'].tolist()} against phase 25's "
          f"{hand['summary']['type_counts'].tolist()}")
    conf_err = abs(summary["mean_confidence"] -
                   hand["summary"]["mean_confidence"])
    check(conf_err <= ENGINE_CONF_ATOL,
          f"pipeline engine {label}: mean confidence off by {conf_err}")
    same_assign = [bool(np.array_equal(seen["seurat_tool"][i]["clusters"][
        "assign"], hand["assign"][i])) for i in range(n)]
    check(all(same_assign), f"pipeline engine {label}: cluster assignments "
          f"differ from phase 25's in samples "
          f"{[i for i, s in enumerate(same_assign) if not s]}")
    loss_err = max(abs(a - b) / abs(b) for got, want_ in
                   zip(losses, hand["losses"]) for a, b in zip(got, want_))
    check(loss_err <= TRAIN_RTOL,
          f"pipeline engine {label}: count losses off by {loss_err}")
    param_err = [max(leaf_diffs(seen["count_tool"][i]["model"],
                                hand["models"][i])) for i in range(n)]
    check(max(param_err) <= ENGINE_PARAM_ATOL,
          f"pipeline engine {label}: count models off by {param_err}")
    bits = sum(e == 0.0 for e in param_err)
    print(f"  against phase 25: assignments equal in {n} of {n} samples, "
          f"type counts {summary['type_counts'].tolist()} equal; mean "
          f"confidence {summary['mean_confidence']!r} (off by "
          f"{conf_err:.3e}); count losses max rel err {loss_err:.3e} "
          f"({'the same bits' if loss_err == 0 else 'not the same bits'}); "
          f"count models the same bits in {bits} of {n} samples, max abs "
          f"err {max(param_err):.3e}", flush=True)

    # what the engine did
    serial = sum(hand["seconds"].values())
    print(f"  makespan {res.wall_seconds:.3f} s through the engine; phase "
          f"25's serial sum of step seconds {serial:.3f} s "
          f"({res.wall_seconds / serial:.2f}x); peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    summary_t = ex.data.transfer_summary()
    print("  transfers (R3 two-step vs R4 elided): " + "; ".join(
        f"{kind} n={int(v['n'])} bytes={int(v['bytes']):,}"
        for kind, v in sorted(summary_t.items())), flush=True)
    for (kind, src, dst), (cnt, nbytes) in sorted(
            transfer_links(res).items(), key=str):
        print(f"    {kind:<11s} {str(src):>10s} -> {dst:<10s} n={cnt:3d} "
              f"bytes={nbytes:>13,}", flush=True)
    out = {"makespan_s": res.wall_seconds, "serial_s": serial,
           "peak_bytes": peak, "launches": launches,
           "transfers": {k: (int(v["n"]), int(v["bytes"]))
                         for k, v in summary_t.items()},
           "loss_rel_err": loss_err, "param_abs_err": max(param_err),
           "bits_equal_models": bits,
           # what phases 39 and 40 hold their runs to
           "summary": summary, "losses": losses,
           "span_s": max(e.end for e in res.events) - t0,
           "least_s": least_invocation_seconds(res.events)}
    if profile:
        wall, busy, top, port = profile_ms(lambda: run_engine(doc))
        print_profile(f"one engine run ({label})", wall, busy, top, port)
        out["busy"] = busy / wall if wall > 0 else float("nan")
    return out


# phases 39-40: the §5 workflow through the port's multi-tenant service
# and through a crash and a resume, each run held to phase 38's result from
# the same seed under phase 38's bars.  Two tenants of equal share, two runs
# at a time, one pool of sites (kept until the service closes), no cache
SERVICE_TENANTS = ("lab_a", "lab_b")
SERVICE_BLOCK = {"max_concurrent": 2,
                 "pool": {"enabled": True, "keepalive_s": None},
                 "tenants": {t: {"share": 1.0} for t in SERVICE_TENANTS}}
SERVICE_CANCEL_AFTER = 8       # completed invocations before the cancel
SERVICE_CANCEL_LIMIT_S = 60.0  # from the cancel to CANCELED
SERVICE_WAIT_S = 300.0         # the longest wait for any batch
RECOVERY_CRASH_AFTER = 12      # completed invocations before the crash
JOURNAL_DIR = os.path.join(ROOT, "build", "chip_smoke")


class DriverKilled(BaseException):
    """Raised from a tick hook: the driver dies with work in flight."""


class TrackedBodies:
    """Wrap step-body factories of a module so that the bodies they make
    count themselves while they run: after a cancel or a crash, the
    invocations the engine abandoned still run on its worker threads, and
    their launches must land before the next launch count starts."""

    def __init__(self, module, factories):
        self.module, self.active = module, 0
        self.real = {name: getattr(module, name) for name in factories}
        self.cond = threading.Condition()

    def _wrap(self, real):
        @functools.wraps(real)
        def factory(*args, **kwargs):
            body = real(*args, **kwargs)

            def run(inputs, ctx):
                with self.cond:
                    self.active += 1
                try:
                    return body(inputs, ctx)
                finally:
                    with self.cond:
                        self.active -= 1
                        self.cond.notify_all()
            return run
        return factory

    def __enter__(self):
        for name, real in self.real.items():
            setattr(self.module, name, self._wrap(real))
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.module, name, real)

    def wait_idle(self, timeout: float) -> None:
        with self.cond:
            idle = self.cond.wait_for(lambda: self.active == 0, timeout)
        check(idle, f"{self.active} abandoned step bodies still running "
              f"after {timeout} s")


def check_pipeline_result(what: str, outputs: dict, want: dict) -> dict:
    """A run's own outputs (summary, per-sample stats) against ``want``
    (phase 38's result, or another run's) under phase 38's bars: type
    counts equal, mean confidence within ENGINE_CONF_ATOL, each count loss
    within TRAIN_RTOL."""
    summary = outputs["summary"]
    losses = [s["losses"] for s in outputs["stats"]]
    n = want["summary"]["n_samples"]
    check(summary["n_samples"] == n and len(losses) == n,
          f"{what}: the summary {summary} or the {len(losses)} stats do not "
          f"cover the {n} samples")
    check(np.array_equal(summary["type_counts"],
                         want["summary"]["type_counts"]),
          f"{what}: type counts {summary['type_counts'].tolist()} against "
          f"{want['summary']['type_counts'].tolist()}")
    conf_err = abs(summary["mean_confidence"] -
                   want["summary"]["mean_confidence"])
    check(conf_err <= ENGINE_CONF_ATOL,
          f"{what}: mean confidence off by {conf_err}")
    loss_err = max(abs(a - b) / abs(b) for got, ref in
                   zip(losses, want["losses"]) for a, b in zip(got, ref))
    check(loss_err <= TRAIN_RTOL, f"{what}: count losses off by {loss_err}")
    return {"summary": summary, "losses": losses, "conf_err": conf_err,
            "loss_err": loss_err,
            "same_bits": conf_err == 0 and loss_err == 0}


def flash_totals(launches: dict) -> dict:
    return {k: launches[k] for k in ("flash_attention",
                                     "flash_attention_bwd")}


def check_launches(what: str, want: dict) -> dict:
    """The launches since the last reset: exactly ``want``'s flash counts,
    no other kernel, all on TRAIN_ROUTES."""
    launches, routes = kernel_launches(), kernel_routes()
    expect = {k: 0 for k in launches}
    expect.update(want)
    check(launches == expect, f"{what}: launched {launches}, expected "
          f"{expect}")
    check_routes(routes, launches, TRAIN_ROUTES, what)
    return flash_totals(launches)


def rerun_launches(rerun, train_steps: int) -> dict:
    """The flash launches of re-running ``rerun``'s invocations: a count
    2 forward and 2 backward a train step, a seurat 2 forward."""
    counts = sum(p.split("@")[0] == "/count" for p in rerun)
    seurats = sum(p.split("@")[0] == "/seurat" for p in rerun)
    return {"flash_attention": counts * 2 * train_steps + seurats * 2,
            "flash_attention_bwd": counts * 2 * train_steps}


def analyzed_bound(cfg, costs: dict) -> dict:
    """The analyzer's cost report of ``cfg``'s one workflow with
    ``costs`` (declared step -> seconds) and no default cost."""
    from repro_torch.core.analyzer import analyze
    report = analyze(cfg, step_costs=costs, default_cost_s=0.0)
    check(not report.errors(), f"the analyzer finds errors: "
          f"{[str(d) for d in report.errors()]}")
    return next(iter(report.cost.values()))


def service_doc(doc: dict, gated: bool) -> dict:
    doc = dict(doc, service=SERVICE_BLOCK)
    if gated:
        doc["analyze"] = {"fail_on": "error"}
    return doc


def run_batch(svc, submissions):
    """Submit ``[(doc, tenant, seed, submit kwargs)]`` through
    ``submit_document`` and wait for all of them: (run ids, wall seconds,
    peak bytes)."""
    reset_kernel_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rids = [svc.submit_document(doc, inputs={"seed": seed}, tenant=tenant,
                                **kw)
            for doc, tenant, seed, kw in submissions]
    for rid in rids:
        svc.wait(rid, timeout=SERVICE_WAIT_S)
    torch.cuda.synchronize()
    return rids, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def print_runs(svc, rids, seeds):
    infos = [svc.status(r) for r in rids]
    t0 = min(i.started_at for i in infos)
    for rid, seed, info in zip(rids, seeds, infos):
        res = svc.result(rid)
        print(f"    {rid} ({info.tenant}, seed {seed}): {info.state}, "
              f"admitted at {info.started_at - t0:.3f} s, finished at "
              f"{info.finished_at - t0:.3f} s, makespan "
              f"{res.wall_seconds:.3f} s", flush=True)


def phase_pipeline_service(own: dict, real: dict, hand_own: dict,
                           doc_own: dict, doc_real: dict):
    """Phase 39: a ``WorkflowService`` over the hybrid document's models,
    two tenants, four runs at the document's size (a), a cancel and a
    resume (b), two runs at PIPELINE_REAL (c), and the analyzer's bound
    against phase 38's spans (d).  ``own`` / ``real``: phase 38's results
    at the two sizes; ``hand_own``: phase 25's at the document's size."""
    from repro_torch import pipeline
    from repro_torch.core import (CANCELED, COMPLETE, ExecutionJournal,
                                  FaultConfig, StreamFlowExecutor,
                                  WorkflowService, load_streamflow_file)
    from repro_torch.core.analyzer import analyze
    phase("pipeline service")
    train_steps = doc_own["tools"]["count"]["implementation"]["args"][
        "train_steps"]
    n = own["summary"]["n_samples"]
    svc = WorkflowService(load_streamflow_file(service_doc(doc_own, False)),
                          fault=FaultConfig(speculative=False))
    out = {}
    part_s = {}
    t_part = time.perf_counter()

    # (a) four runs at the document's size: seeds 0 and 1 for each tenant,
    # lab_b's documents carrying the analyze: gate (d), two at a time
    subs = [(service_doc(doc_own, tenant == "lab_b"), tenant, seed, {})
            for seed in (0, 1) for tenant in SERVICE_TENANTS]
    # (the profiler's device trace of this batch took ~54 s to read on the
    # card: phase 41 took its time)
    rids, wall, peak = run_batch(svc, subs)
    states = [svc.status(r).state for r in rids]
    check(states == [COMPLETE] * 4, f"pipeline service (a): states {states}")
    totals = check_launches("pipeline service (a)", {
        k: 4 * v for k, v in flash_totals(own["launches"]).items()})
    results = [check_pipeline_result(
        f"pipeline service (a) {rid}", svc.result(rid).outputs, own)
        for rid, (_, _, seed, _) in zip(rids, subs) if seed == 0]
    seed1 = [svc.result(rid).outputs for rid, (_, _, seed, _) in
             zip(rids, subs) if seed == 1]
    first = {"summary": seed1[0]["summary"],
             "losses": [s["losses"] for s in seed1[0]["stats"]]}
    pair = check_pipeline_result("pipeline service (a) seed 1, lab_b "
                                 "against lab_a", seed1[1], first)
    check(svc.pool.deploy_count == 2,
          f"pipeline service (a): {svc.pool.deploy_count} deploys")
    makespans = [svc.result(r).wall_seconds for r in rids]
    print(f"  (a) 4 runs of {n} samples, 2 at a time: "
          f"all COMPLETE; the seed-0 runs phase 38's result ("
          f"{'the same bits' if all(r['same_bits'] for r in results) else 'within the bars'}"
          f"; max loss rel err {max(r['loss_err'] for r in results):.3e}), "
          f"the seed-1 runs each other's ("
          f"{'the same bits' if pair['same_bits'] else 'within the bars'}); "
          f"flash launches {totals}; pool deploys "
          f"{svc.pool.deploy_count}", flush=True)
    print_runs(svc, rids, [seed for _, _, seed, _ in subs])
    print(f"  (a) batch wall {wall:.3f} s (phase 38's makespan "
          f"{own['makespan_s']:.3f} s a run, x 4 = "
          f"{4 * own['makespan_s']:.3f} s), peak memory "
          f"{peak / 2**30:.2f} GiB, device busy not measured", flush=True)
    out["a"] = {"wall_s": wall, "makespans_s": makespans,
                "peak_bytes": peak, "launches": totals}
    part_s["a"], t_part = time.perf_counter() - t_part, time.perf_counter()

    # (b) a fifth run, journaled with its payloads, cancelled once its
    # journal holds SERVICE_CANCEL_AFTER completed invocations, beside a
    # seed-1 run of the other tenant; then resumed by a new executor
    os.makedirs(JOURNAL_DIR, exist_ok=True)
    journal = os.path.join(JOURNAL_DIR, "service_cancel.jsonl")
    if os.path.exists(journal):
        os.unlink(journal)
    reset_kernel_launches()
    with TrackedBodies(pipeline, ("count_tool", "seurat_tool")) as bodies:
        victim = svc.submit_document(
            doc_own, inputs={"seed": 0}, tenant="lab_a",
            checkpoint={"journal_path": journal, "include_payloads": True})
        other = svc.submit_document(doc_own, inputs={"seed": 1},
                                    tenant="lab_b")
        deadline = time.time() + SERVICE_WAIT_S
        done = 0
        while True:
            check(not svc.status(victim).terminal,
                  f"pipeline service (b): {victim} ended "
                  f"{svc.status(victim).state} before its cancel")
            check(time.time() < deadline, "pipeline service (b): the "
                  f"journal holds {done} completed invocations after "
                  f"{SERVICE_WAIT_S} s")
            if os.path.exists(journal):
                done = len(ExecutionJournal.replay(journal).completed_steps)
                if done >= SERVICE_CANCEL_AFTER:
                    break
            time.sleep(0.1)
        t_cancel = time.time()
        svc.cancel(victim)
        info = svc.wait(victim, timeout=SERVICE_CANCEL_LIMIT_S)
        to_cancel = time.time() - t_cancel
        check(info.state == CANCELED,
              f"pipeline service (b): {victim} is {info.state}")
        check(svc.wait(other, timeout=SERVICE_WAIT_S).state == COMPLETE,
              f"pipeline service (b): {other} is {svc.status(other).state}")
        check_pipeline_result(f"pipeline service (b) {other}",
                              svc.result(other).outputs, first)
        bodies.wait_idle(SERVICE_WAIT_S)
    state = ExecutionJournal.replay(journal)
    check(state.cancelled, "pipeline service (b): the journal holds no "
          "cancelled state")
    journaled = set(state.completed_steps)

    reset_kernel_launches()
    cfg = load_streamflow_file(doc_own)
    entry = cfg.workflows["single-cell-scatter"]
    ex = StreamFlowExecutor.from_config(cfg,
                                        fault=FaultConfig(speculative=False))
    t0 = time.perf_counter()
    res = ex.resume(journal, entry.workflow, entry.bindings)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    rerun = {e.step for e in res.events if e.status == "completed"}
    check(not rerun & journaled, f"pipeline service (b): the resume re-ran "
          f"completed invocations {sorted(rerun & journaled)}")
    check(rerun | journaled == set(entry.workflow.expand().steps),
          "pipeline service (b): the resume left invocations undone")
    resumed = check_launches("pipeline service (b) resume",
                             rerun_launches(rerun, train_steps))
    check_pipeline_result("pipeline service (b) resume", res.outputs, own)
    print(f"  (b) {victim} cancelled with {len(journaled)} invocations "
          f"journaled completed ({done} when the cancel was sent); CANCELED "
          f"{to_cancel:.3f} s after the cancel; {other} COMPLETE, seed 1's "
          f"result; a new executor resumed {len(rerun)} invocations in "
          f"{resume_s:.3f} s to phase 38's result, flash launches "
          f"{resumed}, none for a journaled invocation", flush=True)
    out["b"] = {"journaled": len(journaled), "rerun": len(rerun),
                "cancel_s": to_cancel, "resume_s": resume_s,
                "launches": resumed}
    part_s["b"], t_part = time.perf_counter() - t_part, time.perf_counter()

    # (c) PIPELINE_REAL: one seed-0 run a tenant, at the same time
    subs = [(doc_real, tenant, 0, {}) for tenant in SERVICE_TENANTS]
    rids, wall, peak = run_batch(svc, subs)
    states = [svc.status(r).state for r in rids]
    check(states == [COMPLETE] * 2, f"pipeline service (c): states {states}")
    real_totals = check_launches("pipeline service (c)", {
        k: 2 * v for k, v in flash_totals(real["launches"]).items()})
    for rid in rids:
        check_pipeline_result(f"pipeline service (c) {rid}",
                              svc.result(rid).outputs, real)
    check(svc.pool.deploy_count == 2,
          f"pipeline service: {svc.pool.deploy_count} deploys over the runs")
    makespans = [svc.result(r).wall_seconds for r in rids]
    print(f"  (c) 2 runs at {PIPELINE_REAL} at once: both phase 38's result; "
          f"flash launches {real_totals}; batch wall {wall:.3f} s (phase "
          f"38's makespan {real['makespan_s']:.3f} s a run), peak memory "
          f"{peak / 2**30:.2f} GiB; pool deploys over all runs "
          f"{svc.pool.deploy_count}", flush=True)
    print_runs(svc, rids, [0, 0])
    out["c"] = {"wall_s": wall, "makespans_s": makespans,
                "peak_bytes": peak, "launches": real_totals}
    svc.close(timeout=SERVICE_WAIT_S)
    part_s["c"], t_part = time.perf_counter() - t_part, time.perf_counter()

    # (d) the analyzer: the gate admitted lab_b's runs in (a); its makespan
    # lower bound from each phase 38 run's least invocation seconds must
    # not exceed that run's span; from phase 25's seconds, printed only
    report = analyze(load_streamflow_file(service_doc(doc_own, True)))
    check(not report.errors(), f"pipeline service (d): the gated document "
          f"has errors {[str(d) for d in report.errors()]}")
    bounds = {}
    for label, doc, run in (("the document's size", doc_own, own),
                            ("PIPELINE_REAL", doc_real, real)):
        cost = analyzed_bound(load_streamflow_file(doc), run["least_s"])
        lb = cost["makespan_lower_bound_s"]
        check(lb <= run["span_s"], f"pipeline service (d) {label}: the "
              f"lower bound {lb} s exceeds the measured span "
              f"{run['span_s']} s")
        bounds[label] = (lb, run["span_s"])
        print(f"  (d) {label}: makespan lower bound {lb:.3f} s (critical "
              f"path {cost['critical_path_s']:.3f} s, total work "
              f"{cost['total_work_s']:.3f} s over "
              f"{cost['max_parallel_slots']} slots) <= phase 38's span "
              f"{run['span_s']:.3f} s ({run['span_s'] / lb:.2f}x)",
              flush=True)
    alone = {f"/{kind}": hand_own["seconds"][kind] /
             (1 if kind in ("mkfastq", "aggregate") else n)
             for kind in PIPELINE_KINDS}
    cost = analyzed_bound(load_streamflow_file(doc_own), alone)
    lb = cost["makespan_lower_bound_s"]
    print(f"  (d) from phase 25's standalone seconds a step "
          f"{ {k: round(v, 5) for k, v in alone.items()} }: bound "
          f"{lb:.3f} s; phase 38's span {own['span_s']:.3f} s is "
          f"{own['span_s'] / lb:.2f}x it; warnings of the gated document: "
          f"{sorted({d.code for d in report.warnings()})}", flush=True)
    out["d"] = {"bounds": bounds, "standalone_bound_s": lb}
    out["launches"] = {k: totals[k] + real_totals[k] for k in totals}
    part_s["d"] = time.perf_counter() - t_part
    print("  the phase's seconds: " + ", ".join(
        f"({k}) {v:.1f}" for k, v in part_s.items()), flush=True)
    out["part_s"] = part_s
    return out


def scatter_args(doc: dict) -> dict:
    """``streamflow_doc_scatter_hybrid``'s arguments for the declarative
    document ``doc``: the two documents then plan the same."""
    tools = doc["tools"]
    sites = doc["models"]
    return {"n_samples": doc["workflows"]["single-cell-scatter"]["steps"][
                "/mkfastq"]["streams"]["shard"],
            "hpc_replicas": sites["occam"]["config"]["services"][
                "cellranger"]["replicas"],
            "cloud_replicas": sites["garr_cloud"]["config"]["services"][
                "r_env"]["replicas"],
            "policy": doc["scheduling"]["policy"],
            **{k: v for k, v in tools["mkfastq"]["implementation"][
                "args"].items() if k != "n_samples"},
            **tools["count"]["implementation"]["args"]}


def phase_pipeline_recovery(own: dict, doc_own: dict):
    """Phase 40: ``streamflow_doc_scatter_hybrid`` (the python builder) at
    ``doc_own``'s size, journaled with its payloads; the driver dies at a
    tick once RECOVERY_CRASH_AFTER invocations have completed, and a new
    executor resumes from the journal alone."""
    from repro_torch import pipeline
    from repro_torch.core import (ExecutionJournal, FaultConfig,
                                  StreamFlowExecutor, load_streamflow_file)
    phase("pipeline recovery")
    os.makedirs(JOURNAL_DIR, exist_ok=True)
    journal = os.path.join(JOURNAL_DIR, "recovery.jsonl")
    if os.path.exists(journal):
        os.unlink(journal)
    args = scatter_args(doc_own)
    doc = pipeline.streamflow_doc_scatter_hybrid(**args)
    doc["checkpoint"] = {"journal_path": journal, "include_payloads": True}
    train_steps = args["train_steps"]
    def crash(tick, completed):
        if len(completed) >= RECOVERY_CRASH_AFTER:
            raise DriverKilled(f"{len(completed)} invocations completed")

    t0 = time.perf_counter()
    # the builder makes the step bodies when the document loads
    with TrackedBodies(pipeline, ("_count_stream_fn",
                                  "_seurat_stream_fn")) as bodies:
        cfg = load_streamflow_file(doc)
        entry = cfg.workflows["single-cell"]
        ex = StreamFlowExecutor.from_config(
            cfg, fault=FaultConfig(speculative=False))
        ex.tick_hook = crash
        try:
            ex.run(entry.workflow, entry.bindings, inputs={"seed": 0})
            check(False, "pipeline recovery: the driver did not die")
        except DriverKilled:
            pass
        running = bodies.active
        bodies.wait_idle(SERVICE_WAIT_S)
    crash_s = time.perf_counter() - t0
    journaled = set(ExecutionJournal.replay(journal).completed_steps)
    check(len(journaled) >= RECOVERY_CRASH_AFTER, f"pipeline recovery: "
          f"{len(journaled)} completed invocations journaled")

    reset_kernel_launches()
    ex2 = StreamFlowExecutor.from_config(load_streamflow_file(doc),
                                         fault=FaultConfig(speculative=False))
    t0 = time.perf_counter()
    res = ex2.resume(journal)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    rerun = {e.step for e in res.events if e.status == "completed"}
    check(not rerun & journaled, f"pipeline recovery: the resume re-ran "
          f"completed invocations {sorted(rerun & journaled)}")
    check(rerun | journaled == set(entry.workflow.expand().steps),
          "pipeline recovery: the resume left invocations undone")
    launches = check_launches("pipeline recovery",
                              rerun_launches(rerun, train_steps))
    got = check_pipeline_result("pipeline recovery", res.outputs, own)
    print(f"  the driver died after {crash_s:.3f} s with "
          f"{len(journaled)} invocations journaled completed and {running} "
          f"step bodies in flight; a new executor resumed from the journal "
          f"alone: {len(rerun)} invocations in {resume_s:.3f} s, flash "
          f"launches {launches}, none for a journaled invocation; phase "
          f"38's result ({'the same bits' if got['same_bits'] else 'within the bars'})",
          flush=True)
    return {"journaled": len(journaled), "rerun": len(rerun),
            "resume_s": resume_s, "launches": launches}


# phases 35-37: the data-parallel step with the int8 error-feedback
# all-reduce, the train driver with a save and a resume, and the dry run's
# count of phase 12's step.  COMPRESSED_LAYERS cuts minicpm-2b's depth for
# the compressed step, which runs beside a plain step from the same init;
# the driver trains the -smoke config as examples/train_e2e_torch.py does
COMPRESSED_LAYERS = 4
DRIVER_STEPS, DRIVER_CUT = 60, 40
# the reference test's bar on every parameter after step 1 of the
# compressed and the plain step (tests/test_dp_compress.py)
COMPRESSED_PARAM_TOL = 5e-2


def free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_train_compressed():
    """Phase 35: minicpm-2b at full width, COMPRESSED_LAYERS layers, as
    phase 12 (float32 masters, bf16 compute, remat "full", 2 microbatches
    of 1 x TRAIN_SEQ, its recipe): TRAIN_STEPS steps of
    ``make_train_step_dp_compressed`` on a one-rank NCCL group beside
    TRAIN_STEPS plain steps from the same init on the same batch.  Step
    1's loss must be the same bits, every parameter after step 1 within
    the reference test's bars and within 2 lr of the plain step's (AdamW
    moves a weight by at most about lr a step), the error feedback exact
    on every leaf (the gradient used plus the new error equals the
    gradient plus the old error, within float32 rounding), the loss
    falling, every step's launches those of phase 12's per layer on
    wgmma_bf16, and one NCCL all-reduce of an int32 payload a leaf a
    step.  Returns {"plain_ms", "compressed_ms", "all_reduce_ms"}."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch, get_schedule
    from repro_torch.data import batch_for
    from repro_torch.launch import steps
    from repro_torch.models import registry as R
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import AdamWConfig, adamw_init, compression
    from repro_torch.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(get_arch(ARCH), n_layers=COMPRESSED_LAYERS)
    phase(f"train compressed {ARCH} {cfg.n_layers} layers")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    calls = {"int32": 0, "other": 0}
    all_reduce = dist.all_reduce
    ef_all_reduce = compression.all_reduce_int8_with_ef
    identity = []       # worst |used + new error - (grad + old error)| bars
    ar_events = []

    def counting_all_reduce(t, *args, **kwargs):
        calls["int32" if t.dtype == torch.int32 else "other"] += 1
        return all_reduce(t, *args, **kwargs)

    def checked_ef_all_reduce(grads, errors, group=None):
        targets = [g.float() + e for g, e in zip(tree_leaves(grads),
                                                 tree_leaves(errors))]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        used, new = ef_all_reduce(grads, errors, group)
        end.record()
        ar_events.append((start, end))
        eps = torch.finfo(torch.float32).eps
        for u, n, t in zip(tree_leaves(used), tree_leaves(new), targets):
            err = float((u.float() + n - t).abs().max())
            bar = 4 * eps * max(float(t.abs().max()), 1e-30)
            identity.append(err / bar)
        return used, new
    dist.all_reduce = counting_all_reduce
    compression.all_reduce_int8_with_ef = checked_ef_all_reduce
    try:
        params = R.init_params(cfg, 0, device="cuda",
                               param_dtype=torch.float32)
        plain = tree_map(lambda p: p.detach().clone(), params)
        opt, opt_plain = adamw_init(params), adamw_init(plain)
        errors = steps.init_ef_errors(params)
        shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in batch_for(cfg, shape, seed=0, step=0).items()}
        ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                           total_steps=TRAIN_STEPS,
                           schedule=get_schedule(ARCH))
        plain_step = steps.make_train_step(cfg, ocfg,
                                           accum_steps=TRAIN_ACCUM,
                                           device="cuda")
        comp_step = steps.make_train_step_dp_compressed(
            cfg, ocfg, accum_steps=TRAIN_ACCUM, device="cuda")
        n_leaves = len(tree_leaves(params))
        want = step_launches(cfg, TRAIN_ACCUM, backward=True)
        print(f"  {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
              f"{R.count_params_analytic(cfg) / 1e9:.3f} B params in "
              f"{n_leaves} leaves; one-rank NCCL group; batch "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} as {TRAIN_ACCUM} microbatches",
              flush=True)
        reset_kernel_launches()
        history = []
        for i in range(TRAIN_STEPS):
            row = {}
            for name, run in (
                    ("plain", lambda: plain_step(plain, opt_plain, batch)),
                    ("compressed", lambda: comp_step(params, opt, errors,
                                                     batch))):
                before = kernel_launches()
                calls.update(int32=0, other=0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                row[name + "_ms"] = (time.perf_counter() - t0) * 1e3
                metrics = out[-1]
                row[name] = {k: float(v) for k, v in metrics.items()}
                delta = {k: v - before[k] for k, v in
                         kernel_launches().items()}
                check(delta == want, f"{name} step {i + 1} launched "
                      f"{delta}, expected {want}")
                if name == "compressed":
                    check(calls["int32"] == n_leaves,
                          f"compressed step {i + 1}: {calls['int32']} "
                          f"int32 all-reduces for {n_leaves} leaves")
                    row["all_reduce_ms"] = ar_events[-1][0].elapsed_time(
                        ar_events[-1][1])
            if i == 0:
                # the reference's bar is 1e-3; from one init and one batch
                # the port's two steps give the same bits
                lp, lc = row["plain"]["loss"], row["compressed"]["loss"]
                check(lp == lc, f"step 1's loss differs: plain {lp!r}, "
                      f"compressed {lc!r}")
                with torch.no_grad():
                    d = max(float((a - b).abs().max()) for a, b in zip(
                        tree_leaves(params), tree_leaves(plain)))
                lr = row["compressed"]["lr"]
                bar = min(COMPRESSED_PARAM_TOL, 2 * lr * (1 + 1e-3))
                print(f"  after step 1: loss {lc!r} on both (the same "
                      f"bits); largest parameter difference {d:.3e} "
                      f"(bar {bar:.3e}: 2 lr = {2 * lr:.3e} and the "
                      f"reference's {COMPRESSED_PARAM_TOL})", flush=True)
                check(d <= bar, f"after step 1 a parameter differs by {d}")
            history.append(row)
            print(f"  step {i + 1}: plain loss {row['plain']['loss']:.5f} "
                  f"{row['plain_ms']:.1f} ms; compressed loss "
                  f"{row['compressed']['loss']:.5f} "
                  f"{row['compressed_ms']:.1f} ms, the all-reduce "
                  f"{row['all_reduce_ms']:.2f} ms "
                  f"({row['all_reduce_ms'] / row['compressed_ms']:.1%})",
                  flush=True)
        check(max(identity) <= 1.0, f"error feedback: worst leaf at "
              f"{max(identity):.3f} of its float32 bar")
        losses = [h["compressed"]["loss"] for h in history]
        check(losses[-1] < losses[0], f"compressed loss did not fall: "
              f"{losses}")
        routes = kernel_routes()
        check_routes(routes, kernel_launches(), TRAIN_ROUTES,
                     "train compressed")
        steady = history[1:]
        out = {k: float(np.median([h[k] for h in steady]))
               for k in ("plain_ms", "compressed_ms", "all_reduce_ms")}
        print(f"  error feedback: worst leaf {max(identity):.3f} of its bar "
              f"(4 float32 eps of the leaf's max |grad + error|); "
              f"{n_leaves} int32 all-reduces a step; median after step 1: "
              f"plain {out['plain_ms']:.1f} ms, compressed "
              f"{out['compressed_ms']:.1f} ms, its all-reduce "
              f"{out['all_reduce_ms']:.2f} ms "
              f"({out['all_reduce_ms'] / out['compressed_ms']:.1%}); "
              f"launches by route {routes}", flush=True)
        return out
    finally:
        dist.all_reduce = all_reduce
        compression.all_reduce_int8_with_ef = ef_all_reduce
        dist.destroy_process_group()
        torch.cuda.empty_cache()


def timed_steps(run, steps: int):
    """``steps`` calls of ``run`` (a train step), each timed to a
    synchronise; returns (each step's float metrics, each step's ms)."""
    metrics, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in out[-1].items()})
    return metrics, ms


def largest_difference(placed, plain) -> float:
    """The largest |a - b| over the leaves of a params tree on a mesh and
    the same tree without one (each rank's pieces against the whole, which
    may lie on the host)."""
    from repro_torch.tree import tree_leaves
    with torch.no_grad():
        return max(float((a.full_tensor() - b.to(a.device)).abs().max())
                   for a, b in zip(tree_leaves(placed), tree_leaves(plain)))


def train_beside_plain(cfg, ocfg, batch, init, placed, mesh, n: int, want,
                       what: str, keys, **kw):
    """``n`` plain train steps of ``cfg`` on ``batch`` from ``init()``,
    then as many with ``mesh=`` from ``placed()`` (the same init placed on
    ``mesh``), each kernel's count reset just before the mesh steps and
    read just after.  Checks the mesh steps' launches (``want`` a step),
    each on its train route, step 1's ``keys`` metrics within TRAIN_RTOL
    of the plain step's and every parameter after step 1 within 2 lr.
    ``kw`` goes to both ``make_train_step`` calls.  Returns the metrics
    and ms of both, the largest parameter difference after step 1
    ("d"), the launches, by route, the mesh steps' peak bytes, and
    whether step 1's ``keys`` are the same bits ("same")."""
    from repro_torch.launch import steps
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map
    kw = dict(accum_steps=TRAIN_ACCUM, device="cuda", **kw)
    plain = init()
    opt = adamw_init(plain)
    step = steps.make_train_step(cfg, ocfg, **kw)
    plain_m, plain_ms = timed_steps(lambda: step(plain, opt, batch), 1)
    # on the host: recurrentgemma-9b's 6-layer state and steps fill the card
    after_one = tree_map(lambda p: p.detach().cpu(), plain)
    more_m, more_ms = timed_steps(lambda: step(plain, opt, batch), n - 1)
    plain_m, plain_ms = plain_m + more_m, plain_ms + more_ms
    del plain, opt
    params = placed()
    opt = adamw_init(params)
    step = steps.make_train_step(cfg, ocfg, mesh=mesh, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    mesh_m, mesh_ms = timed_steps(lambda: step(params, opt, batch), 1)
    d = largest_difference(params, after_one)
    more_m, more_ms = timed_steps(lambda: step(params, opt, batch), n - 1)
    launches, routes = kernel_launches(), kernel_routes()
    mesh_m, mesh_ms = mesh_m + more_m, mesh_ms + more_ms
    peak = torch.cuda.max_memory_allocated()
    del params, opt, after_one
    torch.cuda.empty_cache()
    check(launches == {k: n * v for k, v in want.items()},
          f"{what}: launches {launches} over {n} steps, expected {want} a "
          f"step")
    check_routes(routes, launches, TRAIN_ROUTES, what)
    for k in keys:
        a, b = plain_m[0][k], mesh_m[0][k]
        check(abs(a - b) <= TRAIN_RTOL * abs(a),
              f"{what}: step 1's {k} {b!r}, plain {a!r} (bar {TRAIN_RTOL})")
    lr = mesh_m[0]["lr"]
    check(d <= 2 * lr * (1 + 1e-3), f"{what}: a parameter after step 1 "
          f"differs by {d} > 2 lr")
    return {"plain_m": plain_m, "plain_ms": plain_ms, "mesh_m": mesh_m,
            "mesh_ms": mesh_ms, "d": d, "launches": launches,
            "routes": routes, "peak": peak,
            "same": all(plain_m[0][k] == mesh_m[0][k] for k in keys)}


def phase_train_sharded():
    """Phase 42 (see the module docstring): minicpm-2b at full width,
    COMPRESSED_LAYERS layers, phase 12's recipe (float32 masters, bf16
    compute, remat "full", TRAIN_ACCUM microbatches of 1 x TRAIN_SEQ).
    (a) ``make_train_step(mesh=)`` on a one-rank NCCL group's (1, 1) mesh
    beside the plain step from the same init on the same batch; (b) the
    compressed step with ``mesh=`` on a (1, 1, 1) ("pod", "data", "model")
    mesh beside phase 35's group form; (c) one train step on rank 0 of a
    (1, SHARDED_TP) mesh of fake ranks.  Returns ({kernel: (a)'s
    launches}, {kernel: (a)'s launches by route})."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_arch, get_schedule
    from repro_torch.data import batch_for
    from repro_torch.distributed import sharding
    from repro_torch.kernels.flash_attention.ops import kernel_head_dim
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import registry as R
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = dataclasses.replace(get_arch(ARCH), n_layers=COMPRESSED_LAYERS)
    phase(f"sharded train {ARCH} {cfg.n_layers} layers")
    rules, axes = sharding.RULESETS["base"], R.logical_axes(cfg)
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in batch_for(cfg, shape, seed=0, step=0).items()}
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=TRAIN_STEPS, schedule=get_schedule(ARCH))
    want = step_launches(cfg, TRAIN_ACCUM, backward=True)

    def init():
        return R.init_params(cfg, 0, device="cuda", param_dtype=torch.float32)

    def place(params, mesh):
        return sharding.distribute_tree(
            params, sharding.logical_to_specs(axes, params, mesh, rules),
            mesh)
    print(f"  {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{R.count_params_analytic(cfg) / 1e9:.3f} B params, the base "
          f"ruleset; batch {TRAIN_BATCH} x {TRAIN_SEQ} as {TRAIN_ACCUM} "
          f"microbatches", flush=True)

    # (a) and (b): a one-rank NCCL group
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_local_mesh(1)
        run = train_beside_plain(cfg, ocfg, batch, init,
                                 lambda: place(init(), mesh), mesh,
                                 TRAIN_STEPS, want, "sharded train (a)",
                                 ("loss", "grad_norm"))
        plain_m, plain_ms, sharded_m, sharded_ms, d, launches, routes, \
            peak, same = (run[k] for k in (
                "plain_m", "plain_ms", "mesh_m", "mesh_ms", "d", "launches",
                "routes", "peak", "same"))
        lr = sharded_m[0]["lr"]
        losses = [m["loss"] for m in sharded_m]
        check(losses[-1] < losses[0], f"sharded train (a): the loss did "
              f"not fall: {losses}")
        print(f"  (a) (1, 1) mesh: step 1 loss {sharded_m[0]['loss']!r} "
              f"grad_norm {sharded_m[0]['grad_norm']!r}, plain "
              f"{plain_m[0]['loss']!r} {plain_m[0]['grad_norm']!r} "
              f"({'the same bits' if same else 'not the same bits'}; bar "
              f"{TRAIN_RTOL}); largest parameter difference after step 1 "
              f"{d:.3e} (bar 2 lr = {2 * lr:.3e}); losses {losses}",
              flush=True)
        print(f"  (a) launches over {TRAIN_STEPS} steps {launches} = "
              f"{want} a step, by route {routes}; step ms on the mesh "
              f"{[round(t, 1) for t in sharded_ms]}, median of the last 3 "
              f"{np.median(sharded_ms[1:]):.1f}; plain "
              f"{[round(t, 1) for t in plain_ms]}, median "
              f"{np.median(plain_ms[1:]):.1f} (the difference is DTensor's "
              f"host cost); peak memory of the sharded steps "
              f"{peak / 2**30:.2f} GiB", flush=True)

        # (b) the compressed step on a (1, 1, 1) mesh beside its group form
        pods = init_device_mesh("cuda", (1, 1, 1),
                                mesh_dim_names=("pod", "data", "model"))
        group = init()
        opt_g, err_g = adamw_init(group), steps.init_ef_errors(group)
        group_step = steps.make_train_step_dp_compressed(
            cfg, ocfg, accum_steps=TRAIN_ACCUM, device="cuda")
        placed = place(init(), pods["data", "model"])
        opt, err = adamw_init(placed), steps.init_ef_errors(placed)
        mesh_step = steps.make_train_step_dp_compressed(
            cfg, ocfg, mesh=pods, accum_steps=TRAIN_ACCUM, device="cuda")
        rows = []
        for i in range(2):
            g_m, g_ms = timed_steps(lambda: group_step(group, opt_g, err_g,
                                                       batch), 1)
            m_m, m_ms = timed_steps(lambda: mesh_step(placed, opt, err,
                                                      batch), 1)
            d = largest_difference(placed, group)
            rows.append((g_m[0], m_m[0], d, g_ms[0], m_ms[0]))
        del group, opt_g, err_g, placed, opt, err
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    (g1, m1, d1, _, _), (g2, m2, d2, g_ms, m_ms) = rows
    check(g1["loss"] == m1["loss"], f"sharded train (b): step 1's loss "
          f"{m1['loss']!r} on the mesh, {g1['loss']!r} in the group form")
    bar = min(COMPRESSED_PARAM_TOL, 2 * m1["lr"] * (1 + 1e-3))
    check(d1 <= bar, f"sharded train (b): a parameter after step 1 "
          f"differs by {d1} > {bar}")
    print(f"  (b) compressed step on a (1, 1, 1) (pod, data, model) mesh: "
          f"step 1 loss {m1['loss']!r} (the same bits as the group form's); "
          f"largest parameter difference after step 1 {d1:.3e} (bar "
          f"{bar:.3e}), after step 2 {d2:.3e}; step 2 loss {m2['loss']!r} "
          f"against {g2['loss']!r}; step 2 ms {m_ms:.1f} on the mesh, "
          f"{g_ms:.1f} in the group form", flush=True)

    # (c) rank 0 of a (1, SHARDED_TP) mesh of fake ranks on the card
    with fake_group(SHARDED_TP):
        mesh = make_local_mesh(SHARDED_TP, device_type="cuda")
        placed = place(init(), mesh)
        opt = adamw_init(placed)
        step = steps.make_train_step(cfg, ocfg, accum_steps=TRAIN_ACCUM,
                                     device="cuda", mesh=mesh)
        timed_steps(lambda: step(placed, opt, batch), 1)   # the first
        reset_kernel_launches()
        shapes, restore = record_flash_shapes()
        try:
            _, rank_ms = timed_steps(lambda: step(placed, opt, batch), 1)
        finally:
            restore()
        rank_launches, rank_routes = kernel_launches(), kernel_routes()
        del placed, opt
    torch.cuda.empty_cache()
    heads = cfg.n_heads // SHARDED_TP
    local = (TRAIN_BATCH // TRAIN_ACCUM, TRAIN_SEQ, heads,
             kernel_head_dim(cfg.head_dim))
    check(shapes == {("forward", local): want["flash_attention"],
                     ("backward", local): want["flash_attention_bwd"]},
          f"sharded train (c): flash launches by (pass, q shape) {shapes}, "
          f"expected {want} at {local}")
    check_routes(rank_routes, rank_launches, TRAIN_ROUTES,
                 "sharded train (c)")
    flash_routes = {k: rank_routes[k] for k in ("flash_attention",
                                                "flash_attention_bwd")}
    print(f"  (c) one rank of a (1, {SHARDED_TP}) mesh of fake ranks: a "
          f"train step at {heads} of {cfg.n_heads} heads a rank "
          f"{rank_ms[0]:.1f} ms (the second; one rank's compute with the "
          f"collectives skipped, its outputs not checked); flash launches "
          f"by (pass, q shape) {shapes}, by route {flash_routes}",
          flush=True)
    return launches, routes


def init_placed(cfg, mesh, rules, seed: int = 0):
    """``cfg``'s serving weights drawn one layer at a time on the card
    (``init_params`` of a one-layer model, seed ``seed + n`` for layer n,
    its wo and w2 scaled to the whole model's output scale) and placed on
    ``mesh`` by ``rules`` as each is drawn, so that no more than one layer
    is whole on the card at once.  Needs a one-kind pattern."""
    from repro_torch.distributed import sharding
    from repro_torch.models import registry as R
    check(cfg.pattern_period == 1, f"{cfg.name}: a pattern of one kind")
    axes = R.logical_axes(cfg)
    one = dataclasses.replace(cfg, n_layers=1)
    scale = math.sqrt(one.n_layers / cfg.n_layers)

    def place(tree, tree_axes):
        return sharding.distribute_tree(tree, sharding.logical_to_specs(
            tree_axes, tree, mesh, rules), mesh)
    placed, layers = {}, []
    for n in range(cfg.n_layers):
        params = R.init_params(one, seed + n, device="cuda")
        (layer,) = params.pop("layers")
        with torch.no_grad():
            layer["mix"]["wo"].mul_(scale)
            layer["ffn"]["w2"].mul_(scale)
        layers.append(place(layer, axes["layers"][n]))
        if n == 0:
            placed = {k: place(v, axes[k]) for k, v in params.items()}
        del params, layer
    return {k: layers if k == "layers" else placed[k] for k in axes}


def record_gmm_calls():
    """From now on, record each ``moe_gmm.ops.expert_ffn`` call's (xe
    shape, w1 shape, bucket fills), the first call's arguments, and a pair
    of CUDA events around each kernel launch; returns (the calls, a list
    that holds the first call's (xe, weights, act, fills), the event
    pairs, a function that restores both)."""
    from repro_torch.kernels.moe_gmm import kernel, ops
    real_ffn, real_launch = ops.expert_ffn, kernel.launch
    calls, first, events = [], [], []

    def recording(xe, p, act="swiglu", counts=None):
        calls.append((tuple(xe.shape), tuple(p["w1"].shape), counts))
        if not first:
            first.append((xe, dict(p), act, counts))
        return real_ffn(xe, p, act, counts)

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        real_launch(*args, **kwargs)
        end.record()
        events.append((start, end))
    ops.expert_ffn, kernel.launch = recording, timed

    def restore():
        ops.expert_ffn, kernel.launch = real_ffn, real_launch
    return calls, first, events, restore


def local_heads(cfg, tp: int) -> int:
    """The query heads of a rank's flash launch on a model axis of ``tp``:
    H / tp where the KV heads divide it, else all H (as
    ``transformer._flash_on_local_heads`` leaves them)."""
    if cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0:
        return cfg.n_heads // tp
    return cfg.n_heads


def serve_routes():
    """The route of every launch of a bf16 model's serving."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    return {"flash_attention": fa_kernel.ROUTES[torch.bfloat16][1],
            "moe_gmm": "wgmma_bf16"}


def rank_prefill(cfg, placed, mesh, toks, what):
    """Rank 0's prefill of ``toks`` on ``mesh`` (fake ranks): one untimed,
    then three timed, with every kernel's launches counted and the flash
    kernel's q shapes and moe_gmm's calls recorded over those three.  The
    flash kernel must run 3 x the attention layers at the rank's local
    heads and moe_gmm 3 x the layers, each on its bf16 route; then the
    first recorded moe_gmm call's own inputs (the rank's buckets, weights
    and fills) go through the kernel once more against its plain version
    at GMM_RTOL.  Returns (prefill ms, median of 3; every kernel's
    launches; by route; the moe_gmm numbers at this rank's shapes, with
    the peak memory of the prefills)."""
    from repro_torch.kernels.flash_attention.ops import kernel_head_dim
    from repro_torch.launch.steps import make_prefill_step
    prefill = make_prefill_step(cfg, cache_len=SHARDED_CACHE_LEN,
                                moe_dispatch="gather", device="cuda",
                                mesh=mesh)
    with torch.inference_mode():
        prefill(placed, {"tokens": toks})           # the first, untimed
        torch.cuda.synchronize()
        reset_kernel_launches()
        calls, first, events, restore = record_gmm_calls()
        fa_shapes, fa_restore = record_flash_shapes()
        times = []
        try:
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prefill(placed, {"tokens": toks})
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        finally:
            fa_restore()
            restore()
        peak = torch.cuda.max_memory_allocated()
        launches, routes = kernel_launches(), kernel_routes()
        n_attn = sum(layer_counts(cfg).get(k, 0) for k in ("attn", "swa"))
        want = dict.fromkeys(launches, 0)
        want.update(flash_attention=3 * n_attn, moe_gmm=3 * cfg.n_layers)
        check(launches == want, f"{what}: launches over 3 prefills "
              f"{launches}, expected {want}")
        check_routes(routes, launches, serve_routes(), what)
        heads = local_heads(cfg, SHARDED_TP)
        fa_local = (*toks.shape, heads, kernel_head_dim(cfg.head_dim))
        check(fa_shapes == {("forward", fa_local): 3 * n_attn},
              f"{what}: flash launches by (pass, q shape) {fa_shapes}, "
              f"expected {3 * n_attn} at {fa_local}")
        shapes = {c[:2] for c in calls}
        check(len(shapes) == 1, f"{what}: moe_gmm shapes {shapes}")
        (xe_shape, w1_shape), = shapes
        E_loc, C, d = xe_shape
        f_loc = w1_shape[2]
        kernel_ms = float(np.median([a.elapsed_time(b) for a, b in events]))
        n_live = float(np.mean([int(c[2].sum()) for c in calls]))
        touched = float(np.mean([int((c[2] > 0).sum()) for c in calls]))
        # the kernel on the first call's own buckets, weights and fills,
        # against its plain version (after the path's launches were read)
        xe, p, act, fill = first[0]
        err = run_gmm_case(
            f"{cfg.name} rank", xe, p, act, fill,
            f"{int(fill.sum())} live rows in {int((fill > 0).sum())} of "
            f"{E_loc} experts: the first call of {what}'s prefills")
        del calls, first, xe, p, fill
    bound_ms, bound_by, _, _ = live_rows_bound(n_live, touched, d, f_loc,
                                               torch.bfloat16)
    all_ms, _, _, _ = bound(gmm_cost.work(E_loc, C, d, f_loc, True,
                                          torch.bfloat16), torch.bfloat16)
    prefill_ms = sorted(times)[1] * 1e3
    print(f"  (b) {what}: prefill {SERVE_SLOTS}x{PROMPT_LEN} "
          f"{prefill_ms:.2f} ms (median of 3; one rank's compute with the "
          f"collectives skipped, its logits not checked); moe_gmm at "
          f"(E, C, d, f) = {(E_loc, C, d, f_loc)}: "
          f"{launches['moe_gmm'] // 3} launches a prefill by route "
          f"{routes['moe_gmm']}, {kernel_ms:.4f} ms a launch (CUDA events, "
          f"median), {n_live:.0f} live rows in {touched:.1f} experts on "
          f"average; bound over them {bound_ms * 1e3:.2f} us by {bound_by}"
          f", over all {E_loc} x {C} rows {all_ms * 1e3:.2f} us; its "
          f"first call against the plain version max_abs_err {err:.3e}; "
          f"flash {launches['flash_attention'] // 3} launches a prefill at "
          f"q {fa_local} ({heads} of {cfg.n_heads} heads), by route "
          f"{routes['flash_attention']}", flush=True)
    return prefill_ms, launches, routes, {
        "shape": [E_loc, C, d, f_loc], "launches": launches["moe_gmm"],
        "launches_by_route": routes["moe_gmm"], "ms": kernel_ms,
        "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_all_rows_ms": all_ms, "live_rows": n_live,
        "touched_experts": touched, "peak_bytes": peak}


def moe_train_on_mesh(mesh):
    """Phase 43 (a)'s train steps: granite-moe at MOE_TRAIN_LAYERS layers,
    phase 12's recipe with the gather dispatch and the ``ep`` ruleset,
    MOE_MESH_TRAIN_STEPS on ``mesh`` beside as many plain steps
    (``train_beside_plain``).  Returns (the mesh steps' launches, by
    route)."""
    from repro_torch.configs import get_arch, get_schedule
    from repro_torch.data import batch_for
    from repro_torch.distributed import sharding
    from repro_torch.models import registry as R
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in batch_for(cfg, shape, seed=0, step=0).items()}
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=TRAIN_STEPS,
                       schedule=get_schedule(MOE_ARCH))

    def init():
        return R.init_params(cfg, 0, device="cuda", param_dtype=torch.float32)

    def placed():
        params = init()
        return sharding.distribute_tree(params, sharding.logical_to_specs(
            R.logical_axes(cfg), params, mesh, sharding.RULESETS["ep"]),
            mesh)
    n, keys = MOE_MESH_TRAIN_STEPS, ("loss", "aux", "grad_norm")
    run = train_beside_plain(
        cfg, ocfg, batch, init, placed, mesh, n,
        step_launches(cfg, TRAIN_ACCUM, backward=True,
                      moe_dispatch="gather"),
        "sharded moe train", keys, moe_dispatch="gather")
    mesh_m, plain_m = run["mesh_m"][0], run["plain_m"][0]
    print(f"  (a) train {cfg.n_layers} layers, ep, gather, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} as {TRAIN_ACCUM} microbatches: step "
          f"1 {', '.join(f'{k} {mesh_m[k]!r}' for k in keys)}, plain "
          f"{', '.join(repr(plain_m[k]) for k in keys)} ("
          f"{'the same bits' if run['same'] else 'not the same bits'}; bar "
          f"{TRAIN_RTOL}); largest parameter difference after step 1 "
          f"{run['d']:.3e} (bar 2 lr); launches over {n} steps "
          f"{run['launches']}, by route {run['routes']}; step ms on the "
          f"mesh {[round(t, 1) for t in run['mesh_ms']]}, plain "
          f"{[round(t, 1) for t in run['plain_ms']]}", flush=True)
    return run["launches"], run["routes"]


def phase_moe_sharded(cfg, params):
    """Phase 43 (see the module docstring): granite-moe's serving (the
    params of phase 5, full depth, bf16) under the ``ep`` and ``base``
    rulesets on a one-rank mesh beside the same steps without one, and a
    4-layer train step there; then rank 0's prefill on a (1, SHARDED_TP)
    mesh of fake ranks under both rulesets, and mixtral-8x7b's at all its
    layers under ``ep``.  Every kernel's launches are counted from 0 on
    each path and checked.  Returns ({path: every kernel's launches},
    {path: their launches by route}, {path: moe_gmm at one rank's
    shapes})."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import registry as R
    from repro_torch.tree import tree_leaves
    phase(f"sharded moe {cfg.name}")
    axes = R.logical_axes(cfg)
    toks = np.random.default_rng(43).integers(
        1, cfg.vocab_size, size=(SERVE_SLOTS, PROMPT_LEN)).astype(np.int32)
    launches, routes, at_rank = {}, {}, {}
    n_attn = sum(layer_counts(cfg).get(k, 0) for k in ("attn", "swa"))
    rank = f"rank 0 of (1, {SHARDED_TP})"

    def place(params, mesh, ruleset):
        return sharding.distribute_tree(params, sharding.logical_to_specs(
            axes, params, mesh, sharding.RULESETS[ruleset]), mesh)

    # (a) a one-rank NCCL group, a (1, 1) mesh
    plain = serve_greedy(cfg, params, toks, steps=MOE_MESH_DECODE,
                         moe_dispatch="gather")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_local_mesh(1)
        for ruleset in ("ep", "base"):
            placed = place(params, mesh, ruleset)
            reset_kernel_launches()
            prefill_ms, decode_ms, tokens, logits, _ = serve_greedy(
                cfg, placed, toks, mesh, steps=MOE_MESH_DECODE,
                moe_dispatch="gather")
            path = f"{MOE_ARCH} sharded {ruleset}"
            launches[path], routes[path] = kernel_launches(), kernel_routes()
            del placed
            # flash in each prefill (decode attends without it), moe_gmm
            # in each prefill and decode step
            want = dict.fromkeys(launches[path], 0)
            want.update(flash_attention=3 * n_attn,
                        moe_gmm=cfg.n_layers * (3 + MOE_MESH_DECODE))
            check(launches[path] == want,
                  f"sharded moe ({ruleset}): launches {launches[path]}, "
                  f"expected {want}")
            check_routes(routes[path], launches[path], serve_routes(),
                         f"sharded moe ({ruleset})")
            check(torch.equal(plain[2], tokens),
                  f"sharded moe ({ruleset}): greedy tokens differ from the "
                  f"unsharded steps': {plain[2].T.tolist()} against "
                  f"{tokens.T.tolist()}")
            err = float((plain[3] - logits).abs().max())
            check(err <= SHARDED_LOGITS_BAR,
                  f"sharded moe ({ruleset}): logits differ by {err:.3e} > "
                  f"{SHARDED_LOGITS_BAR}")
            print(f"  (a) (1, 1) mesh, {ruleset} ruleset, gather: the same "
                  f"{MOE_MESH_DECODE + 1} greedy tokens a row as the "
                  f"unsharded steps; logits' largest difference {err:.3e} "
                  f"(bar {SHARDED_LOGITS_BAR}; "
                  f"{'the same bits' if err == 0 else 'not the same bits'}"
                  f"); moe_gmm launches {want['moe_gmm']} = {cfg.n_layers} "
                  f"layers x (3 prefills + {MOE_MESH_DECODE} decode steps), "
                  f"by route {routes[path]['moe_gmm']}; flash "
                  f"{want['flash_attention']} = {n_attn} layers x 3 "
                  f"prefills, by route {routes[path]['flash_attention']}; "
                  f"prefill {SERVE_SLOTS}x"
                  f"{PROMPT_LEN} {prefill_ms:.2f} ms on the mesh, "
                  f"{plain[0]:.2f} ms without (median of 3); decode "
                  f"{decode_ms:.3f} ms/step on the mesh, {plain[1]:.3f} "
                  f"without, at batch {SERVE_SLOTS}", flush=True)
        launches[f"{MOE_ARCH} sharded train"], \
            routes[f"{MOE_ARCH} sharded train"] = moe_train_on_mesh(mesh)
    finally:
        dist.destroy_process_group()

    # (b) rank 0 of a (1, SHARDED_TP) mesh of fake ranks on the card
    with fake_group(SHARDED_TP):
        mesh = make_local_mesh(SHARDED_TP, device_type="cuda")
        for ruleset in ("ep", "base"):
            placed = place(params, mesh, ruleset)
            path = f"{MOE_ARCH} {ruleset} {rank}"
            _, launches[path], routes[path], at = rank_prefill(
                cfg, placed, mesh, toks, path)
            at_rank[f"{MOE_ARCH} {ruleset}"] = at
            del placed
            torch.cuda.empty_cache()
        E_loc, f_loc = (at_rank[f"{MOE_ARCH} {r}"]["shape"][k]
                        for r, k in (("ep", 0), ("base", 3)))
        check(E_loc * SHARDED_TP == cfg.n_experts and
              f_loc * SHARDED_TP == cfg.d_ff,
              f"sharded moe (b): {E_loc} experts (ep) and d_ff {f_loc} "
              f"(base) a rank of {cfg.n_experts} and {cfg.d_ff}")
        mix = get_arch(MIXTRAL_ARCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        placed = init_placed(mix, mesh, sharding.RULESETS["ep"])
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        held = sum(sharding.local(t).nbytes for t in tree_leaves(placed))
        mix_toks = np.random.default_rng(43).integers(
            1, mix.vocab_size, size=(SERVE_SLOTS, PROMPT_LEN)).astype(
                np.int32)
        path = f"{MIXTRAL_ARCH} ep {rank}"
        prefill_ms, launches[path], routes[path], at = rank_prefill(
            mix, placed, mesh, mix_toks, path)
        at_rank[f"{MIXTRAL_ARCH} ep"], peak = at, at["peak_bytes"]
        del placed
    torch.cuda.empty_cache()
    shape = at_rank[f"{MIXTRAL_ARCH} ep"]["shape"]
    check(shape[0] * SHARDED_TP == mix.n_experts,
          f"sharded moe (b): mixtral's {shape[0]} experts a rank")
    at_rank[f"{MIXTRAL_ARCH} ep"].update(prefill_ms=prefill_ms,
                                         weights_bytes=held)
    print(f"  (b) {MIXTRAL_ARCH} at all {mix.n_layers} layers on rank 0 of "
          f"(1, {SHARDED_TP}), ep: {shape[0]} of {mix.n_experts} experts a "
          f"rank, {held / 1e9:.3f} GB of bf16 weights a rank (drawn layer "
          f"by layer in {init_s:.1f} s), prefill {SERVE_SLOTS}x{PROMPT_LEN} "
          f"{prefill_ms:.2f} ms, peak memory {peak / 2**30:.2f} GiB "
          f"({peak / 1e9:.2f} GB) with phase 6's granite-moe resident",
          flush=True)
    return launches, routes, at_rank


def record_kernel_calls():
    """From now on, record each call of the flash, RG-LRU and mLSTM
    kernels' wrappers as the blocks make it (``transformer.flash_attention``,
    ``rglru.rglru_scan``, ``mlstm_scan.ops.mlstm_chunkwise``): its first
    tensor's shape, and each kernel's first call's arguments.  Returns
    ({kernel: [shapes]}, {kernel: (args, kwargs)}, a function that restores
    the three)."""
    from repro_torch.kernels.mlstm_scan import ops as ml_ops
    from repro_torch.models import rglru, transformer
    where = {"flash_attention": (transformer, "flash_attention"),
             "rglru_scan": (rglru, "rglru_scan"),
             "mlstm_scan": (ml_ops, "mlstm_chunkwise")}
    real = {k: getattr(m, n) for k, (m, n) in where.items()}
    shapes, first = {k: [] for k in where}, {}

    def wrap(name):
        def call(*args, **kwargs):
            shapes[name].append(tuple(args[0].shape))
            first.setdefault(name, (args, kwargs))
            return real[name](*args, **kwargs)
        return call
    for name, (module, attr) in where.items():
        setattr(module, attr, wrap(name))

    def restore():
        for name, (module, attr) in where.items():
            setattr(module, attr, real[name])
    return shapes, first, restore


def check_first_calls(first: dict, what: str) -> dict:
    """Each kernel's first recorded call (``record_kernel_calls``) through
    the kernel again, against its plain version on the same inputs, within
    its bar (KERNEL_TOL absolute for flash; RGLRU_RTOL and MLSTM_RTOL of
    the plain version's scale); each timed by CUDA events beside its bound,
    its plain version and, for flash, SDPA (``sdpa_ms``).
    On fake ranks the collectives leave their outputs unwritten, so the
    call's activations are drawn anew from a seed at its shapes, dtypes
    and layout (flash's q, k, v; the RG-LRU's x and gates; the mLSTM's q,
    k, v and gates), and its parameters (lam, b_a, b_i) and keywords kept.
    Returns {kernel: {shape, max_abs_err, rel_err, ms, plain_ms,
    library_ms, bound_ms, bound_by}}."""
    from repro_torch.kernels.flash_attention import ops as fa_ops, \
        ref as fa_ref
    from repro_torch.kernels.mlstm_scan import ops as ml_ops, ref as ml_ref
    from repro_torch.kernels.rglru_scan import ops as rg_ops, ref as rg_ref
    gen = torch.Generator(device="cuda").manual_seed(44)

    def drawn(t, shift=0.0):
        return (torch.randn(t.shape, generator=gen, device=t.device) +
                shift).to(t.dtype)
    out = {}
    with torch.inference_mode():
        for name, (args, kw) in sorted(first.items()):
            if name == "rglru_scan":
                x, lam, ga, gx = args
                args = (drawn(x), lam, drawn(ga), drawn(gx))
            else:
                # the mLSTM's forget gates near the init's biases, 3-6
                args = tuple(drawn(t, 4.0 if i == 4 else 0.0)
                             for i, t in enumerate(args))
            if name == "flash_attention":
                q, k, v = args
                run = functools.partial(fa_ops.flash_attention, q, k, v,
                                        **kw)
                plain = functools.partial(fa_ref.reference_attention, q, k,
                                          v, **kw)
                want = fa_ref.reference_attention(q.float(), k.float(),
                                                  v.float(), **kw)
                got = run()
                err = float((got.float() - want).abs().max())
                rel, tol, bar = err, KERNEL_TOL[q.dtype], "absolute"
                B, S, H, Dh = q.shape
                work = bound(fa_cost.work(B, S, H, k.shape[2], Dh,
                                          kw["causal"], kw["window"],
                                          q.dtype), q.dtype)
            elif name == "rglru_scan":
                x, lam, ga, gx = args
                run = functools.partial(rg_ops.rglru, *args, **kw)
                plain = functools.partial(rg_ref.reference_rglru, *args,
                                          **kw)
                (y, h), (wy, wh) = run(), plain()
                err = max(float((y - wy).abs().max()),
                          float((h - wh).abs().max()))
                rel, tol, bar = err / float(wy.abs().max()), RGLRU_RTOL, \
                    "of max |y|"
                work = bound(rg_cost.work(*x.shape, x.dtype, ga.dtype, False,
                                          "b_a" in kw), torch.float32)
            else:
                q = args[0]
                run = functools.partial(ml_ops.mlstm_chunkwise, *args, **kw)
                plain = functools.partial(ml_ref.reference_mlstm, *args,
                                          chunk=MLSTM_PLAIN_CHUNK)
                h, state = run()
                wh, wstate = plain()
                err = float((h - wh).abs().max())
                rel, tol, bar = max(rel_errs((h,) + state,
                                             (wh,) + wstate).values()), \
                    MLSTM_RTOL, "of each of h, C, n, m's scale"
                work = bound(ml_cost.work(*q.shape, q.dtype, False), q.dtype)
            ms, plain_ms = cuda_ms(run), cuda_ms(plain, iters=5)
            library_ms = sdpa_ms(*args, kw["causal"], kw["window"])[0] \
                if name == "flash_attention" else None
            bound_ms, bound_by, _, _ = work
            print(f"  {what}: {name}'s first call at {tuple(args[0].shape)} "
                  f"again against its plain version: max_abs_err {err:.3e}, "
                  f"{rel:.3e} {bar} (bar {tol:.0e}); {ms:.4f} ms (CUDA "
                  f"events), plain {plain_ms:.4f} ms"
                  + (f", sdpa {library_ms:.4f} ms" if library_ms else "")
                  + f", bound {bound_ms * 1e3:.2f} us by {bound_by}",
                  flush=True)
            check(math.isfinite(rel) and rel <= tol,
                  f"{what}: {name}'s first call differs from its plain "
                  f"version by {rel} > {tol}")
            out[name] = {"shape": list(args[0].shape), "max_abs_err": err,
                         "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by}
    return out


def recurrent_prefill_launches(cfg, prefills: int) -> dict:
    """Every kernel's launches over ``prefills`` prefills of a recurrent
    config: flash once a LOCAL layer, rglru_scan once an RG-LRU layer,
    mlstm_scan once an mLSTM layer, each a prefill; none in decode."""
    counts = layer_counts(cfg)
    want = dict.fromkeys(kernel_launches(), 0)
    want.update(flash_attention=prefills * counts.get("local", 0),
                rglru_scan=prefills * counts.get("rglru", 0),
                mlstm_scan=prefills * counts.get("mlstm", 0))
    return want


def rank_shapes(cfg, tp: int) -> dict:
    """The first-tensor shapes the kernels receive on a rank of a model
    axis of ``tp`` in a SERVE_SLOTS x PROMPT_LEN prefill: flash q at H / tp
    heads (one KV head: the query heads split, ``transformer.
    _flash_on_local_heads``), rglru x at D / tp channels, mlstm q at H / tp
    heads (all H where H does not divide tp)."""
    from repro_torch.kernels.flash_attention.ops import kernel_head_dim
    from repro_torch.models.xlstm import mlstm_dims
    B, S = SERVE_SLOTS, PROMPT_LEN
    kv_split = cfg.n_kv_heads % tp == 0 or cfg.n_kv_heads == 1
    H = cfg.n_heads // tp if cfg.n_heads % tp == 0 and kv_split \
        else cfg.n_heads
    H_ml, Dh_ml, _ = mlstm_dims(cfg)
    return {"flash_attention": (B, S, H, cfg.head_dim),
            "rglru_scan": (B, S, cfg.d_model // tp),
            "mlstm_scan": (B, S, H_ml // tp if H_ml % tp == 0 else H_ml,
                           Dh_ml)}


def phase_recurrent_sharded(cfg, params, n_layers=None):
    """Phase 44 (a) or (c), and (d) (see the module docstring): ``cfg``'s
    serving (its serve phase's bf16 params, cut to ``n_layers`` layers if
    given) on a one-rank mesh under ``base`` beside the same steps without
    one, the mesh's decode steps fed the unsharded steps' greedy tokens;
    then rank 0's prefill on a (1, SHARDED_TP) mesh of fake ranks, each
    kernel's shapes and first call checked.  Every kernel's launches are
    counted from 0 on each path and checked.  Returns ({path: every
    kernel's launches}, {path: by route}, {kernel: its numbers at the
    rank's shapes})."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import registry as R
    if n_layers is not None:
        n_layers = min(n_layers, cfg.n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        params = dict(params, layers=params["layers"][:n_layers])
    phase(f"sharded recurrent {cfg.name} ({cfg.n_layers} layers)")
    axes = R.logical_axes(cfg)
    rules = sharding.RULESETS["base"]
    toks = np.random.default_rng(44).integers(
        1, cfg.vocab_size, size=(SERVE_SLOTS, PROMPT_LEN)).astype(np.int32)
    routes_want = {"flash_attention": serve_routes()["flash_attention"],
                   "rglru_scan": "fused_bias", "mlstm_scan": "wgmma_bf16"}
    launches, routes = {}, {}

    def place(mesh):
        return sharding.distribute_tree(params, sharding.logical_to_specs(
            axes, params, mesh, rules), mesh)

    # (a) / (c) a one-rank NCCL group, a (1, 1) mesh
    plain = serve_greedy(cfg, params, toks, steps=RECURRENT_MESH_DECODE)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        placed = place(make_local_mesh(1))
        mesh = placed["final_ln"].device_mesh
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_launches()
        prefill_ms, decode_ms, tokens, logits, _ = serve_greedy(
            cfg, placed, toks, mesh, steps=RECURRENT_MESH_DECODE,
            feed=plain[2])
        path = f"{cfg.name} sharded"
        launches[path], routes[path] = kernel_launches(), kernel_routes()
        mesh_peak = torch.cuda.max_memory_allocated()
        del placed
    finally:
        dist.destroy_process_group()
    want = recurrent_prefill_launches(cfg, 3)
    check(launches[path] == want, f"sharded recurrent {cfg.name}: launches "
          f"{launches[path]}, expected {want}")
    check_routes(routes[path], launches[path], routes_want,
                 f"sharded recurrent {cfg.name}")
    err = float((plain[3] - logits).abs().max())
    check(err <= SHARDED_LOGITS_BAR,
          f"sharded recurrent {cfg.name}: logits differ by {err:.3e} > "
          f"{SHARDED_LOGITS_BAR}")
    agree = int((plain[2] == tokens).sum())
    print(f"  (1, 1) mesh, base: logits of 3 prefills and "
          f"{RECURRENT_MESH_DECODE} decode steps fed the unsharded steps' "
          f"greedy tokens, largest difference {err:.3e} (bar "
          f"{SHARDED_LOGITS_BAR}; "
          f"{'the same bits' if err == 0 else 'not the same bits'}); "
          f"{agree} of {tokens.numel()} greedy tokens the same; launches "
          f"{ {k: v for k, v in launches[path].items() if v} } by route "
          f"{ {k: routes[path][k] for k in routes_want} }; prefill "
          f"{SERVE_SLOTS}x{PROMPT_LEN} {prefill_ms:.2f} ms on the mesh, "
          f"{plain[0]:.2f} ms without (median of 3); decode "
          f"{decode_ms:.3f} ms/step on "
          f"the mesh, {plain[1]:.3f} without, at batch {SERVE_SLOTS}; "
          f"peak memory on the mesh {mesh_peak / 2**30:.2f} GiB (the "
          f"weights resident)",
          flush=True)

    # (d) rank 0 of a (1, SHARDED_TP) mesh of fake ranks on the card
    rank = f"{cfg.name} rank 0 of (1, {SHARDED_TP})"
    with fake_group(SHARDED_TP):
        placed = place(make_local_mesh(SHARDED_TP, device_type="cuda"))
        mesh = placed["final_ln"].device_mesh
        prefill = make_prefill_step(cfg, cache_len=SHARDED_CACHE_LEN,
                                    device="cuda", mesh=mesh)
        with torch.inference_mode():
            prefill(placed, {"tokens": toks})       # the first, untimed
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_kernel_launches()
            shapes, first, restore = record_kernel_calls()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prefill(placed, {"tokens": toks})
                torch.cuda.synchronize()
                rank_ms = (time.perf_counter() - t0) * 1e3
            finally:
                restore()
            launches[rank], routes[rank] = kernel_launches(), kernel_routes()
        peak = torch.cuda.max_memory_allocated()
        want = recurrent_prefill_launches(cfg, 1)
        check(launches[rank] == want, f"{rank}: launches {launches[rank]}, "
              f"expected {want}")
        check_routes(routes[rank], launches[rank], routes_want, rank)
        local = rank_shapes(cfg, SHARDED_TP)
        for name, got in shapes.items():
            check(got == [local[name]] * want[name],
                  f"{rank}: {name} received {sorted(set(got))} "
                  f"({len(got)} calls), expected {want[name]} at "
                  f"{local[name]}")
        at_rank = check_first_calls(first, rank)
        for name in at_rank:
            at_rank[name]["launches"] = want[name]
        del placed, first
    torch.cuda.empty_cache()
    print(f"  (d) {rank}: prefill {SERVE_SLOTS}x{PROMPT_LEN} "
          f"{rank_ms:.2f} ms (one rank's compute with the collectives "
          f"skipped, its logits not checked), peak memory "
          f"{peak / 2**30:.2f} GiB; kernels at "
          f"{ {k: local[k] for k in at_rank} }", flush=True)
    return launches, routes, at_rank


def phase_recurrent_sharded_train():
    """Phase 44 (b): recurrentgemma-9b at GRIFFIN_TRAIN_LAYERS layers (at
    TRAIN_SEQ) and xlstm-1.3b at XLSTM_TRAIN_LAYERS (at
    XLSTM_MESH_TRAIN_SEQ),
    phase 12's recipe and the ``base`` ruleset, RECURRENT_MESH_TRAIN_STEPS
    steps each on a one-rank mesh beside as many plain steps from the same
    init (``train_beside_plain``): the rglru and mlstm backwards under a
    mesh.  Returns ({path: launches}, {path: by route})."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch, get_schedule
    from repro_torch.data import batch_for
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import registry as R
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import AdamWConfig
    phase("sharded recurrent train")
    launches, routes = {}, {}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_local_mesh(1)
        for arch, n_layers, seq in ((GRIFFIN_ARCH, GRIFFIN_TRAIN_LAYERS,
                                     TRAIN_SEQ),
                                    (XLSTM_ARCH, XLSTM_TRAIN_LAYERS,
                                     XLSTM_MESH_TRAIN_SEQ)):
            cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers)
            shape = ShapeSpec("train", seq, TRAIN_BATCH, "train")
            batch = {k: torch.as_tensor(v, device="cuda") for k, v in
                     batch_for(cfg, shape, seed=0, step=0).items()}
            ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                               total_steps=TRAIN_STEPS,
                               schedule=get_schedule(arch))

            def init(cfg=cfg):
                return R.init_params(cfg, 0, device="cuda",
                                     param_dtype=torch.float32)

            def placed(cfg=cfg):
                params = init()
                return sharding.distribute_tree(
                    params, sharding.logical_to_specs(
                        R.logical_axes(cfg), params, mesh,
                        sharding.RULESETS["base"]), mesh)
            n, keys = RECURRENT_MESH_TRAIN_STEPS, ("loss", "grad_norm")
            path = f"{arch} sharded train"
            run = train_beside_plain(
                cfg, ocfg, batch, init, placed, mesh, n,
                step_launches(cfg, TRAIN_ACCUM, backward=True),
                path, keys)
            launches[path], routes[path] = run["launches"], run["routes"]
            mesh_m, plain_m = run["mesh_m"][0], run["plain_m"][0]
            print(f"  (b) {arch}, {n_layers} layers, base, batch "
                  f"{TRAIN_BATCH} x {seq} as {TRAIN_ACCUM} microbatches: "
                  f"step 1 {', '.join(f'{k} {mesh_m[k]!r}' for k in keys)}"
                  f", plain {', '.join(repr(plain_m[k]) for k in keys)} ("
                  f"{'the same bits' if run['same'] else 'not the same bits'}"
                  f"; bar {TRAIN_RTOL}); "
                  f"largest parameter difference after "
                  f"step 1 {run['d']:.3e} (bar 2 lr); launches over {n} "
                  f"steps { {k: v for k, v in run['launches'].items() if v} }"
                  f"; step ms on the mesh "
                  f"{[round(t, 1) for t in run['mesh_ms']]}, plain "
                  f"{[round(t, 1) for t in run['plain_ms']]}; peak "
                  f"{run['peak'] / 2**30:.2f} GiB", flush=True)
            del batch
    finally:
        dist.destroy_process_group()
    return launches, routes


def cross_cache_pieces(cache) -> list:
    """Each CROSS layer's ck: (its placements, this rank's piece's
    shape)."""
    return [(tuple(layer["ck"].placements),
             tuple(layer["ck"].to_local().shape))
            for layer in cache["layers"] if "ck" in layer]


def cross_cache_piece(cfg, tp: int):
    """What ``cache_specs`` makes of a CROSS layer's ck (SERVE_SLOTS, P,
    KH, Dh) on a rank of a (1, tp) mesh: sequence-sharded from 1024
    patches on (P / tp a rank), else along Dh."""
    from torch.distributed.tensor import Shard
    P, KH, Dh = cfg.n_patches, cfg.n_kv_heads, cfg.head_dim
    if P >= 1024:
        return (Shard(0), Shard(1)), (SERVE_SLOTS, P // tp, KH, Dh)
    return (Shard(0), Shard(3)), (SERVE_SLOTS, P, KH, Dh // tp)


def phase_vision_sharded(cfg, params):
    """Phase 45 (a) and (b) (see the module docstring): llama-3.2-vision's
    serving (phase 18's bf16 weights, full depth) on a one-rank mesh under
    ``base`` beside the same steps without one, the patch memory's ck/cv
    of n_patches sequence-sharded by ``cache_specs``; then rank 0's
    prefill on a (1, SHARDED_TP) mesh of fake ranks.  Every kernel's
    launches are counted from 0 on each path and checked.  Returns
    ({path: every kernel's launches}, {path: by route}, flash's numbers at
    the rank's shapes)."""
    import torch.distributed as dist
    from repro_torch.data.frontends import vision_patches
    from repro_torch.distributed import sharding
    from repro_torch.kernels.flash_attention.ops import kernel_head_dim
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import registry as R
    from repro_torch.tree import tree_leaves
    phase(f"sharded vision and audio: {cfg.name} ({cfg.n_layers} layers)")
    axes = R.logical_axes(cfg)
    rules = sharding.RULESETS["base"]
    toks = np.random.default_rng(45).integers(
        1, cfg.vocab_size, size=(SERVE_SLOTS, PROMPT_LEN)).astype(np.int32)
    extra = {"patches": vision_patches(SERVE_SLOTS, cfg.n_patches,
                                       cfg.frontend_dim, seed=45)}
    n_attn = layer_counts(cfg).get("attn", 0)
    n_cross = layer_counts(cfg).get("cross", 0)
    fa_route = {"flash_attention": serve_routes()["flash_attention"]}
    launches, routes = {}, {}

    def place(mesh):
        return sharding.distribute_tree(params, sharding.logical_to_specs(
            axes, params, mesh, rules), mesh)

    # (a) a one-rank NCCL group, a (1, 1) mesh
    plain = serve_greedy(cfg, params, toks, steps=VISION_MESH_DECODE,
                         extra=extra)[:4]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        placed = place(make_local_mesh(1))
        mesh = placed["final_ln"].device_mesh
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_launches()
        masks, restore = record_flash_masks()
        try:
            prefill_ms, decode_ms, tokens, logits, cache = serve_greedy(
                cfg, placed, toks, mesh, steps=VISION_MESH_DECODE,
                extra=extra)
        finally:
            restore()
        path = f"{cfg.name} sharded"
        launches[path], routes[path] = kernel_launches(), kernel_routes()
        mesh_peak = torch.cuda.max_memory_allocated()
        one_rank_cross = cross_cache_pieces(cache)
        del placed, cache
    finally:
        dist.destroy_process_group()
    want = dict.fromkeys(launches[path], 0)
    want["flash_attention"] = 3 * n_attn
    check(launches[path] == want, f"sharded {cfg.name}: launches "
          f"{launches[path]} over 3 prefills and {VISION_MESH_DECODE} decode "
          f"steps, expected {want}: {n_attn} a prefill, none in decode")
    check(masks == {("forward", True): 3 * n_attn},
          f"sharded {cfg.name}: flash launches by (pass, causal) {masks}")
    check_routes(routes[path], launches[path], fa_route,
                 f"sharded {cfg.name}")
    check(one_rank_cross == [cross_cache_piece(cfg, 1)] * n_cross,
          f"sharded {cfg.name}: the CROSS caches {one_rank_cross}")
    err = float((plain[3] - logits).abs().max())
    check(err <= SHARDED_LOGITS_BAR,
          f"sharded {cfg.name}: logits differ by {err:.3e} > "
          f"{SHARDED_LOGITS_BAR}")
    check(torch.equal(plain[2], tokens),
          f"sharded {cfg.name}: greedy tokens {tokens.tolist()}, without "
          f"a mesh {plain[2].tolist()}")
    print(f"  (a) (1, 1) mesh, base: 3 prefills of {SERVE_SLOTS}x"
          f"{PROMPT_LEN} tokens with {cfg.n_patches} patches a row and "
          f"{VISION_MESH_DECODE} greedy decode steps beside the same steps "
          f"without a mesh: the same greedy tokens, logits' largest "
          f"difference {err:.3e} (bar {SHARDED_LOGITS_BAR}; "
          f"{'the same bits' if err == 0 else 'not the same bits'}); "
          f"flash {launches[path]['flash_attention']} launches = {n_attn} "
          f"ATTN layers x 3 prefills, all causal, by route "
          f"{routes[path]['flash_attention']}, none in decode; the "
          f"{n_cross} CROSS caches {one_rank_cross[0]} (decode through "
          f"the combine where sequence-sharded); prefill {prefill_ms:.2f} ms on the "
          f"mesh, {plain[0]:.2f} ms without (median of 3); decode "
          f"{decode_ms:.3f} ms/step on the mesh, {plain[1]:.3f} without, "
          f"at batch {SERVE_SLOTS}; peak memory on the mesh "
          f"{mesh_peak / 2**30:.2f} GiB (the weights resident)", flush=True)

    # (b) rank 0 of a (1, SHARDED_TP) mesh of fake ranks on the card
    rank = f"{cfg.name} rank 0 of (1, {SHARDED_TP})"
    with fake_group(SHARDED_TP):
        placed = place(make_local_mesh(SHARDED_TP, device_type="cuda"))
        mesh = placed["final_ln"].device_mesh
        held = sum(sharding.local(t).nbytes for t in tree_leaves(placed))
        prefill = make_prefill_step(cfg, cache_len=SHARDED_CACHE_LEN,
                                    device="cuda", mesh=mesh)
        batch = {"tokens": toks, **extra}
        with torch.inference_mode():
            prefill(placed, batch)                  # the first, untimed
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_kernel_launches()
            fa_shapes, fa_restore = record_flash_shapes()
            shapes, first, restore = record_kernel_calls()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, cache = prefill(placed, batch)
                torch.cuda.synchronize()
                rank_ms = (time.perf_counter() - t0) * 1e3
            finally:
                restore()
                fa_restore()
            launches[rank], routes[rank] = kernel_launches(), kernel_routes()
            rank_cross = cross_cache_pieces(cache)
            del cache
        peak = torch.cuda.max_memory_allocated()
        want = dict.fromkeys(launches[rank], 0)
        want["flash_attention"] = n_attn
        check(launches[rank] == want, f"{rank}: launches {launches[rank]}, "
              f"expected {want}")
        check_routes(routes[rank], launches[rank], fa_route, rank)
        heads = local_heads(cfg, SHARDED_TP)
        local = (SERVE_SLOTS, PROMPT_LEN, heads, cfg.head_dim)
        got = shapes["flash_attention"]
        check(got == [local] * n_attn, f"{rank}: flash received "
              f"{sorted(set(got))}, expected {n_attn} calls at {local}")
        padded = local[:3] + (kernel_head_dim(cfg.head_dim),)
        check(fa_shapes == {("forward", padded): n_attn},
              f"{rank}: flash launches by (pass, q shape) {fa_shapes}")
        rank_piece = cross_cache_piece(cfg, SHARDED_TP)
        check(rank_cross == [rank_piece] * n_cross,
              f"{rank}: the CROSS caches {rank_cross}, expected "
              f"{rank_piece}")
        at_rank = check_first_calls(first, rank)["flash_attention"]
        at_rank["launches"] = n_attn
        del placed, first
    torch.cuda.empty_cache()
    kv_heads = cfg.n_kv_heads * heads // cfg.n_heads
    print(f"  (b) {rank}: prefill {SERVE_SLOTS}x{PROMPT_LEN} with "
          f"{cfg.n_patches} patches {rank_ms:.2f} ms (one rank's compute "
          f"with the collectives skipped, its logits not checked); weights "
          f"a rank {held / 1e9:.3f} GB; peak memory {peak / 2**30:.2f} GiB "
          f"(phase 18's whole weights resident beside them); flash at q "
          f"{local} ({heads} of {cfg.n_heads} heads over {kv_heads} KV "
          f"heads); the CROSS caches {rank_piece}", flush=True)
    return launches, routes, at_rank


def check_flash_bwd_at(args, kw, what):
    """The flash backward at the shapes and dtype of a recorded forward
    call (its q, k, v and dO drawn anew from a seed: on fake ranks the
    collectives leave activations unwritten), through the wrapper's
    autograd function against the plain backward at BWD_TOL, timed beside
    its bound (``time_kernel_bwd``)."""
    from repro_torch.kernels.flash_attention import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(45)
    q, k, v = (torch.randn(t.shape, generator=gen, device="cuda")
               .to(t.dtype).requires_grad_() for t in args)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    o = ops.flash_attention(q, k, v, **kw)
    grads = torch.autograd.grad(o, (q, k, v), do)
    qd, kd, vd = (t.detach() for t in (q, k, v))
    lse = ref.reference_attention_lse(qd, kd, **kw)
    want = ref.reference_attention_bwd(qd, kd, vd, o.detach(), lse, do, **kw)
    errs, abs_err = bwd_errors(grads, want, False)
    tol = BWD_TOL[q.dtype]
    print(f"  {what}: the flash backward at {tuple(q.shape)} {kw} against "
          f"its plain version: rel err dq {errs[0]:.3e} dk {errs[1]:.3e} dv "
          f"{errs[2]:.3e} (bar {tol:.0e})", flush=True)
    check(all(math.isfinite(e) and e <= tol for e in errs),
          f"{what}: flash backward errors {errs} > {tol}")
    del grads, want, o
    timing = time_kernel_bwd(qd, kd, vd, do, kw["causal"], kw["window"],
                             abs_err)
    return {"shape": list(q.shape), "rel_err": max(errs), **timing}


def phase_audio_sharded():
    """Phase 45 (c) and (d) (see the module docstring): hubert-xlarge at
    full width and depth under ``base``.  (c) on a one-rank mesh, an
    encode of 1 x TRAIN_SEQ frames beside the same without one (bf16
    weights), then AUDIO_MESH_TRAIN_STEPS train steps of phase 12's recipe
    beside as many plain ones (``train_beside_plain``); (d) rank 0 of a
    (1, SHARDED_TP) mesh of fake ranks: a train step, the flash calls'
    shapes, and the first call's forward and backward at its shapes
    against the plain versions.  Returns ({path: launches}, {path: by
    route}, {"forward", "backward": flash's numbers at the rank's
    shapes})."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch, get_schedule
    from repro_torch.data import batch_for
    from repro_torch.distributed import sharding
    from repro_torch.kernels.flash_attention.ops import kernel_head_dim
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import registry as R
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = get_arch(AUDIO_ARCH)
    phase(f"sharded vision and audio: {cfg.name} ({cfg.n_layers} layers)")
    axes, rules = R.logical_axes(cfg), sharding.RULESETS["base"]
    launches, routes = {}, {}

    def place(params, mesh):
        return sharding.distribute_tree(params, sharding.logical_to_specs(
            axes, params, mesh, rules), mesh)

    def init():
        return R.init_params(cfg, 0, device="cuda", param_dtype=torch.float32)
    frames = torch.as_tensor(batch_for(cfg, ShapeSpec(
        "encode", TRAIN_SEQ, 1, "train"), seed=3)["frames"], device="cuda")
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch_for(
        cfg, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train"), seed=0,
        step=0).items()}
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=TRAIN_STEPS,
                       schedule=get_schedule(AUDIO_ARCH))
    want_step = step_launches(cfg, TRAIN_ACCUM, backward=True)

    def encode(params, mesh=None):
        """The first, untimed, then the median of 3; (ms, logits)."""
        times = []
        with torch.inference_mode():
            for i in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = R.forward_logits(params, cfg, {"frames": frames},
                                       device="cuda", mesh=mesh)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            out = out.full_tensor() if mesh is not None else out
        return sorted(times[1:])[1] * 1e3, out.float()

    # (c) a one-rank NCCL group, a (1, 1) mesh
    p16 = R.init_params(cfg, 0, device="cuda")
    plain_ms, plain_out = encode(p16)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_local_mesh(1)
        placed16 = place(p16, mesh)
        reset_kernel_launches()
        masks, restore = record_flash_masks()
        try:
            mesh_ms, mesh_out = encode(placed16, mesh)
        finally:
            restore()
        enc = f"{cfg.name} sharded encode"
        launches[enc], routes[enc] = kernel_launches(), kernel_routes()
        del placed16
        train_masks, restore = record_flash_masks()
        path = f"{cfg.name} sharded train"
        try:
            run = train_beside_plain(
                cfg, ocfg, batch, init, lambda: place(init(), mesh), mesh,
                AUDIO_MESH_TRAIN_STEPS, want_step, path,
                ("loss", "grad_norm"))
        finally:
            restore()
        launches[path], routes[path] = run["launches"], run["routes"]
    finally:
        dist.destroy_process_group()
    del p16
    want = dict.fromkeys(launches[enc], 0)
    want["flash_attention"] = 4 * cfg.n_layers
    check(launches[enc] == want, f"{enc}: launches {launches[enc]}, "
          f"expected {want}")
    check(masks == {("forward", False): 4 * cfg.n_layers},
          f"{enc}: flash launches by (pass, causal) {masks}")
    check_routes(routes[enc], launches[enc],
                 {"flash_attention": TRAIN_ROUTES["flash_attention"]}, enc)
    check(set(train_masks) == {("forward", False), ("backward", False)},
          f"{path}: flash launches by (pass, causal) {train_masks}: none "
          f"causal")
    err = float((plain_out - mesh_out).abs().max())
    check(err <= SHARDED_LOGITS_BAR,
          f"{enc}: logits differ by {err:.3e} > {SHARDED_LOGITS_BAR}")
    keys = ("loss", "grad_norm")
    mesh_m, plain_m = run["mesh_m"][0], run["plain_m"][0]
    print(f"  (c) (1, 1) mesh, base: encode 1 x {TRAIN_SEQ} frames, bf16 "
          f"weights: logits' largest difference {err:.3e} (bar "
          f"{SHARDED_LOGITS_BAR}; "
          f"{'the same bits' if err == 0 else 'not the same bits'}), "
          f"{mesh_ms:.2f} ms on the mesh, {plain_ms:.2f} ms without (median "
          f"of 3), flash {cfg.n_layers} launches a call, not causal, by "
          f"route {routes[enc]['flash_attention']}; {AUDIO_MESH_TRAIN_STEPS}"
          f" train steps at batch {TRAIN_BATCH} x {TRAIN_SEQ} as "
          f"{TRAIN_ACCUM} microbatches: step 1 "
          f"{', '.join(f'{k} {mesh_m[k]!r}' for k in keys)}, plain "
          f"{', '.join(repr(plain_m[k]) for k in keys)} ("
          f"{'the same bits' if run['same'] else 'not the same bits'}; bar "
          f"{TRAIN_RTOL}); largest parameter difference after step 1 "
          f"{run['d']:.3e} (bar 2 lr); launches "
          f"{ {k: v for k, v in run['launches'].items() if v} } by (pass, "
          f"causal) {train_masks} (plain and mesh steps); step ms on the "
          f"mesh {[round(t, 1) for t in run['mesh_ms']]}, plain "
          f"{[round(t, 1) for t in run['plain_ms']]}; peak "
          f"{run['peak'] / 2**30:.2f} GiB", flush=True)

    # (d) rank 0 of a (1, SHARDED_TP) mesh of fake ranks on the card
    rank = f"{cfg.name} rank 0 of (1, {SHARDED_TP}) train"
    with fake_group(SHARDED_TP):
        mesh = make_local_mesh(SHARDED_TP, device_type="cuda")
        placed = place(init(), mesh)
        opt = adamw_init(placed)
        step = steps.make_train_step(cfg, ocfg, accum_steps=TRAIN_ACCUM,
                                     device="cuda", mesh=mesh)
        timed_steps(lambda: step(placed, opt, batch), 1)   # the first
        reset_kernel_launches()
        fa_shapes, fa_restore = record_flash_shapes()
        shapes, first, restore = record_kernel_calls()
        try:
            _, rank_ms = timed_steps(lambda: step(placed, opt, batch), 1)
        finally:
            restore()
            fa_restore()
        launches[rank], routes[rank] = kernel_launches(), kernel_routes()
        del placed, opt
        torch.cuda.empty_cache()
        heads = local_heads(cfg, SHARDED_TP)
        local = (TRAIN_BATCH // TRAIN_ACCUM, TRAIN_SEQ, heads, cfg.head_dim)
        padded = local[:3] + (kernel_head_dim(cfg.head_dim),)
        check(launches[rank] == want_step, f"{rank}: launches "
              f"{launches[rank]}, expected {want_step}")
        check_routes(routes[rank], launches[rank], TRAIN_ROUTES, rank)
        check(fa_shapes == {("forward", padded):
                            want_step["flash_attention"],
                            ("backward", padded):
                            want_step["flash_attention_bwd"]},
              f"{rank}: flash launches by (pass, q shape) {fa_shapes}")
        check(set(shapes["flash_attention"]) == {local},
              f"{rank}: flash received {set(shapes['flash_attention'])}")
        at_rank = {"forward": check_first_calls(first, rank)[
            "flash_attention"]}
        args, kw = first["flash_attention"]
        at_rank["backward"] = check_flash_bwd_at(args, kw, rank)
        at_rank["forward"]["launches"] = want_step["flash_attention"]
        at_rank["backward"]["launches"] = want_step["flash_attention_bwd"]
        del first, args
    torch.cuda.empty_cache()
    print(f"  (d) {rank}: a train step {rank_ms[0]:.1f} ms (the second; "
          f"one rank's compute with the collectives skipped, its outputs "
          f"not checked); flash at q {local} ({heads} of {cfg.n_heads} "
          f"heads, Dh {cfg.head_dim} padded to {padded[3]}), launches by "
          f"(pass, q shape) {fa_shapes}", flush=True)
    return launches, routes, at_rank


def phase_train_driver():
    """Phase 36: ``examples/train_e2e_torch.py``'s path through
    ``launch/train.py`` on the card (minicpm-2b -smoke, batch 8 x 128,
    a checkpoint every 40 steps): DRIVER_STEPS steps straight, and
    DRIVER_CUT steps then a second run that resumes from the checkpoint at
    DRIVER_CUT and ends at DRIVER_STEPS.  Both runs' final checkpoints must
    hold the same bits in every leaf (the flash backward is deterministic);
    the seconds a step, to save and to restore are printed."""
    import importlib.util
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.store import latest_step, load_checkpoint
    from repro_torch.configs import get_arch
    from repro_torch.models import registry as R
    from repro_torch.optim import adamw_init
    phase("train driver")
    spec = importlib.util.spec_from_file_location(
        "train_e2e_torch", os.path.join(ROOT, "examples",
                                        "train_e2e_torch.py"))
    e2e = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(e2e)
    with tempfile.TemporaryDirectory() as tmp:
        straight, cut = os.path.join(tmp, "straight"), os.path.join(tmp,
                                                                    "cut")
        args = ["--steps", str(DRIVER_STEPS)]
        t0 = time.perf_counter()
        e2e.main(args + ["--ckpt-dir", straight])
        straight_s = time.perf_counter() - t0
        e2e.main(args + ["--ckpt-dir", cut, "--stop-at", str(DRIVER_CUT)])
        check(latest_step(cut) == DRIVER_CUT,
              f"the cut run ended at step {latest_step(cut)}")
        t0 = time.perf_counter()
        resumed = e2e.main(args + ["--ckpt-dir", cut])
        resumed_s = time.perf_counter() - t0
        check(resumed and resumed[0]["step"] == DRIVER_CUT + 1,
              f"the second run did not resume at step {DRIVER_CUT + 1}")
        a = load_checkpoint(straight, latest_step(straight))
        b = load_checkpoint(cut, latest_step(cut))
        check(a[0] == b[0] == DRIVER_STEPS, f"final steps {a[0]}, {b[0]}")
        diff = {k: float((a[1][k].double() - b[1][k].double()).abs().max())
                for k in a[1]}
        worst = max(diff, key=diff.get)
        print(f"  straight against resumed at step {DRIVER_STEPS}: "
              f"{len(diff)} leaves, {sum(v > 0 for v in diff.values())} "
              f"differ; largest difference {diff[worst]:.3e} ({worst})",
              flush=True)
        check(diff[worst] == 0.0, f"the resumed run's {worst} differs from "
              f"the straight run's by {diff[worst]}")
        # save and restore timed on the trained state
        cfg = get_arch(ARCH + "-smoke")
        params = R.init_params(cfg, 0, device="cuda",
                               param_dtype=torch.float32)
        templates = {"params": params, "opt": adamw_init(params)}
        mgr = CheckpointManager(straight, cfg)
        t0 = time.perf_counter()
        _, trees, _ = mgr.restore_latest(templates)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        CheckpointManager(os.path.join(tmp, "again"), cfg).save(
            DRIVER_STEPS, trees)
        save_s = time.perf_counter() - t0
    out = {"straight_s": straight_s, "step_s": straight_s / DRIVER_STEPS,
           "resumed_s": resumed_s, "save_s": save_s,
           "restore_s": restore_s}
    print(f"  {DRIVER_STEPS} steps straight in {straight_s:.2f} s "
          f"({out['step_s']:.4f} s a step, start-up and saves included); "
          f"the resumed run's {DRIVER_STEPS - DRIVER_CUT} steps in "
          f"{resumed_s:.2f} s; save {save_s:.3f} s, restore "
          f"{restore_s:.3f} s ({cfg.name}, "
          f"{R.count_params_analytic(cfg):,} params, float32 weights and "
          f"moments)", flush=True)
    return out


def phase_dryrun(card: str, train_out: dict):
    """Phase 37: ``launch/dryrun.py``'s count of phase 12's step on
    ``meta`` (minicpm-2b at full depth, TRAIN_BATCH x TRAIN_SEQ as
    TRAIN_ACCUM microbatches, remat "full"): model FLOPs, the counted
    FLOPs and their ratio, each kernel's counted calls (which must equal
    the launches phase 12 checked each step), the predicted memory of the
    step's arguments, beside phase 12's measured step time and peak
    memory, and model FLOPs over (step seconds x the card's bf16 peak).
    Then the mesh that ``distributed.meshselect.preferred_mesh`` picks for
    minicpm-2b's train_4k on a node of AUTO_MESH_CHIPS cards, counted on
    as many fake ranks at accum 1: its split and the record's bound."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.meshselect import preferred_mesh
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    from repro_torch.models.config import SHAPES_BY_NAME, ShapeSpec
    phase(f"dryrun {ARCH}")
    cfg = get_arch(ARCH)
    t0 = time.perf_counter()
    rec = lower_cell(ARCH, ShapeSpec("phase12", TRAIN_SEQ, TRAIN_BATCH,
                                     "train"), accum_steps=TRAIN_ACCUM)
    count_s = time.perf_counter() - t0
    calls = {k: v["calls"] for k, v in rec["counted"]["kernels"].items()}
    want = {k: v for k, v in step_launches(cfg, TRAIN_ACCUM,
                                           backward=True).items() if v}
    check(calls == want, f"dryrun: counted kernel calls {calls}, phase 12 "
          f"launched {want} a step")
    ro, mem = rec["roofline"], rec["memory"]
    step_s = float(np.median([s["ms"] for s in train_out["steps"][1:]])) \
        / 1e3
    share = ro["model_flops"] / (step_s * PEAK_FLOPS_BF16)
    print(f"  counted on meta in {count_s:.1f} s: model FLOPs "
          f"{ro['model_flops']:.4e}, counted "
          f"{ro['counted_flops_global']:.4e} (model / counted {ro['useful_ratio']:.4f}), traffic "
          f"{rec['counted']['traffic_bytes']:.4e} B; kernel calls {calls} "
          f"= phase 12's launches a step; bound {ro['bound_s']:.4f} s by "
          f"{ro['dominant']}", flush=True)
    print(f"  memory: arguments {mem['argument_size_in_bytes'] / 2**30:.2f} "
          f"GiB predicted ({mem['argument_parts']}), temporaries "
          f"{mem['temp_size_in_bytes'] / 2**30:.2f} GiB (an estimate); "
          f"phase 12's peak {train_out['peak_bytes'] / 2**30:.2f} GiB",
          flush=True)
    print(f"  phase 12's step {step_s:.4f} s (median after the first): "
          f"model FLOPs / (step s x {PEAK_FLOPS_BF16:.3e}) = {share:.2%} "
          f"on {card}", flush=True)
    shape = SHAPES_BY_NAME["train_4k"]
    dp, tp, rules = preferred_mesh(cfg, shape, AUTO_MESH_CHIPS)
    check(dp * tp == AUTO_MESH_CHIPS, f"dryrun: preferred_mesh gave dp {dp} "
          f"x tp {tp} for {AUTO_MESH_CHIPS} cards")
    t0 = time.perf_counter()
    auto = lower_cell(ARCH, shape, dp=dp, tp=tp, ruleset=rules)
    check("error" not in auto and "skip" not in auto,
          f"dryrun: the auto mesh's cell gave "
          f"{auto.get('error') or auto.get('skip')}")
    auto_ro, auto_mem = auto["roofline"], auto["memory"]
    auto_gb = (auto_mem["argument_size_in_bytes"] +
               auto_mem["temp_size_in_bytes"]) / 1e9
    print(f"  auto mesh: {ARCH} {shape.name} on {AUTO_MESH_CHIPS} cards -> "
          f"dp {dp} x tp {tp}, {rules} (meshselect's table, predicted by "
          f"the dry run); counted on {auto['mesh']} fake ranks in "
          f"{time.perf_counter() - t0:.1f} s at accum 1: bound "
          f"{auto_ro['bound_s']:.6g} s by {auto_ro['dominant']}, arguments "
          f"+ temporaries {auto_gb:.1f} GB a card", flush=True)
    return {"step_s": step_s, "model_flops": ro["model_flops"],
            "auto_mesh": {"dp": dp, "tp": tp, "ruleset": rules,
                          "bound_s": auto_ro["bound_s"]},
            "counted_flops": ro["counted_flops_global"],
            "useful_ratio": ro["useful_ratio"], "share_of_peak": share,
            "argument_bytes": mem["argument_size_in_bytes"],
            "temp_bytes_estimate": mem["temp_size_in_bytes"],
            "peak_bytes": train_out["peak_bytes"], "calls": calls}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this runs on the GPU",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    card = phase_device()
    phase_build()
    fa_timing = phase_kernel()
    bwd_timing = phase_kernel_bwd()
    rg_bwd_timing = phase_kernel_rglru_bwd()
    ml_bwd_timing = phase_kernel_mlstm_bwd()
    gmm_timing = phase_kernel_moe()
    gmm_bwd_timing = phase_kernel_moe_bwd()
    rg_timing = phase_kernel_rglru()
    ml_timing = phase_kernel_mlstm()
    routes = {}     # {arch: {kernel: launches by route}}
    cfg, params, dense_launches, routes[ARCH] = phase_serve(ARCH)
    phase_consistency(cfg, params)
    sharded_launches, routes[f"{ARCH} sharded"] = \
        phase_serve_sharded(cfg, params)
    del params
    torch.cuda.empty_cache()
    cfg, params, moe_launches, routes[MOE_ARCH] = \
        phase_serve(MOE_ARCH, moe_dispatch="gather")
    phase_consistency(cfg, params, moe_dispatch="gather")
    moe_mesh_launches, moe_mesh_routes, moe_at_rank = \
        phase_moe_sharded(cfg, params)
    del params
    torch.cuda.empty_cache()
    cfg, params, griffin_launches, routes[GRIFFIN_ARCH] = \
        phase_serve(GRIFFIN_ARCH)
    phase_consistency(cfg, params, tol=GRIFFIN_CONSISTENCY_RTOL)
    rec_mesh_launches, rec_mesh_routes, griffin_at_rank = \
        phase_recurrent_sharded(cfg, params)
    del params
    torch.cuda.empty_cache()
    cfg, params, xlstm_launches, routes[XLSTM_ARCH] = \
        phase_serve(XLSTM_ARCH, profile_len=XLSTM_PROFILE_LEN,
                    n_layers=XLSTM_SERVE_LAYERS)
    phase_consistency(cfg, params, tol=XLSTM_CONSISTENCY_RTOL)
    more, more_routes, xlstm_at_rank = phase_recurrent_sharded(
        cfg, params, XLSTM_MESH_LAYERS)
    rec_mesh_launches.update(more)
    rec_mesh_routes.update(more_routes)
    del params
    torch.cuda.empty_cache()
    more, more_routes = phase_recurrent_sharded_train()
    rec_mesh_launches.update(more)
    rec_mesh_routes.update(more_routes)
    train_launches, train_routes, train_out = phase_train()
    phase_train_consistency()
    griffin_train, griffin_train_routes, _ = phase_train(
        GRIFFIN_ARCH, GRIFFIN_TRAIN_LAYERS)
    phase_train_consistency(GRIFFIN_ARCH, GRIFFIN_CONSIST_LAYERS,
                            RECURRENT_CONSIST_SEQ)
    xlstm_train, xlstm_train_routes, _ = phase_train(
        XLSTM_ARCH, XLSTM_TRAIN_LAYERS, XLSTM_TRAIN_SEQ, profile=False)
    phase_train_consistency(XLSTM_ARCH, XLSTM_CONSIST_LAYERS,
                            RECURRENT_CONSIST_SEQ)
    cfg, params, vision_launches, routes[VISION_ARCH], _ = \
        phase_serve_vision()
    modal_launches, modal_routes, vision_at_rank = \
        phase_vision_sharded(cfg, params)
    del params
    torch.cuda.empty_cache()
    phase_consistency_vision()
    audio_train, audio_train_routes, _ = phase_train(AUDIO_ARCH,
                                                     extra=time_encode)
    phase_train_consistency(AUDIO_ARCH, AUDIO_CONSIST_LAYERS,
                            AUDIO_CONSIST_SEQ)
    more, more_routes, hubert_at_rank = phase_audio_sharded()
    modal_launches.update(more)
    modal_routes.update(more_routes)
    phase_train_moe_dispatches()
    moe_train, moe_train_routes, _ = phase_train_moe_full()
    phase_train_consistency(MOE_ARCH, MOE_CONSIST_LAYERS, MOE_CONSIST_SEQ,
                            tol=MOE_TRAIN_RTOL, moe_dispatch="gather")
    from repro_torch import pipeline
    own_label = "streamflow_doc_declarative_hybrid's own arguments"
    pipe_own = phase_pipeline(own_label,
                              pipeline.streamflow_doc_declarative_hybrid())
    real_label = f"at {PIPELINE_REAL}"
    pipe_real = phase_pipeline(
        real_label,
        pipeline.streamflow_doc_declarative_hybrid(**PIPELINE_REAL))
    phase_pipeline_consistency()
    doc_own = pipeline.streamflow_doc_declarative_hybrid()
    doc_real = pipeline.streamflow_doc_declarative_hybrid(**PIPELINE_REAL)
    engine_own = phase_pipeline_engine(own_label, doc_own, pipe_own,
                                       profile=True)
    engine_real = phase_pipeline_engine(real_label, doc_real, pipe_real,
                                        profile=False)
    del pipe_real["models"]
    service = phase_pipeline_service(engine_own, engine_real, pipe_own,
                                     doc_own, doc_real)
    recovery = phase_pipeline_recovery(engine_own, doc_own)
    del pipe_own
    zoo_launches, zoo_routes = phase_zoo()
    routes.update(zoo_routes)
    phase_train_compressed()
    sharded_train, sharded_train_routes = phase_train_sharded()
    phase_train_driver()
    phase_dryrun(card, train_out)

    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
         # launches and times on its first path (minicpm-2b serving); the
         # other paths' counts, each checked in its serve phase, the counts
         # by route (bf16 on wgmma_bf16), and the times at granite-moe's
         # (GQA) and recurrentgemma's (head dim 256, MQA) prefill shapes
         "launches": dense_launches["flash_attention"],
         **fa_timing["minicpm-prefill"],
         "launches_by_path": {
             ARCH: dense_launches["flash_attention"],
             MOE_ARCH: moe_launches["flash_attention"],
             GRIFFIN_ARCH: griffin_launches["flash_attention"],
             XLSTM_ARCH: xlstm_launches["flash_attention"],
             VISION_ARCH: vision_launches["flash_attention"],
             f"{ARCH} train": train_launches["flash_attention"],
             f"{GRIFFIN_ARCH} train": griffin_train["flash_attention"],
             f"{AUDIO_ARCH} train": audio_train["flash_attention"],
             f"{MOE_ARCH} train": moe_train["flash_attention"],
             "pipeline": sum(v["flash_attention"]
                             for v in pipe_real["launches"].values()),
             "pipeline engine": engine_real["launches"]["flash_attention"],
             # phase 39's batches (a) and (c), phase 40's resume
             "pipeline service": service["launches"]["flash_attention"],
             "pipeline recovery": recovery["launches"]["flash_attention"],
             **{arch: n["flash_attention"]
                for arch, n in zoo_launches.items()},
             # phase 41 (a): 3 prefills of its first 10 layers on a (1, 1)
             # mesh
             f"{ARCH} sharded": sharded_launches["flash_attention"],
             # phase 42 (a): 4 train steps on a (1, 1) mesh, 4 layers
             f"{ARCH} sharded train": sharded_train["flash_attention"],
             # phase 43: granite-moe's 3 prefills on a (1, 1) mesh under
             # each ruleset, its 4-layer train steps there, and 3 prefills
             # on rank 0 of (1, 4) (granite under both, mixtral under ep)
             **{path: n["flash_attention"]
                for path, n in moe_mesh_launches.items()},
             # phase 44: recurrentgemma-9b's prefill on a (1, 1) mesh and
             # on rank 0 of (1, 4) (4 of 16 query heads over its one KV
             # head), its 6-layer train steps there
             **{path: n["flash_attention"]
                for path, n in rec_mesh_launches.items()
                if n["flash_attention"]},
             # phase 45: llama-3.2-vision's 3 prefills on a (1, 1) mesh and
             # one on rank 0 of (1, 4); hubert-xlarge's 4 encodes and 2
             # train steps on the (1, 1) mesh, a train step on rank 0 of
             # (1, 4)
             **{path: n["flash_attention"]
                for path, n in modal_launches.items()}},
         "launches_by_route": {
             **{arch: r["flash_attention"] for arch, r in routes.items()},
             f"{ARCH} train": train_routes["flash_attention"],
             f"{ARCH} sharded train":
                 sharded_train_routes["flash_attention"],
             **{path: r["flash_attention"]
                for path, r in moe_mesh_routes.items()},
             **{path: r["flash_attention"]
                for path, r in rec_mesh_routes.items()
                if rec_mesh_launches[path]["flash_attention"]},
             **{path: r["flash_attention"]
                for path, r in modal_routes.items()},
             f"{GRIFFIN_ARCH} train": griffin_train_routes["flash_attention"],
             f"{AUDIO_ARCH} train": audio_train_routes["flash_attention"]},
         "at_granite_shape": fa_timing["granite-prefill"],
         "at_griffin_shape": fa_timing["griffin-prefill"],
         # llama-3.2-vision's prefill (GQA 32/8, Dh 128) and hubert's train
         # shape (16/16, Dh 80 padded to 120, not causal)
         "at_vision_shape": fa_timing["vision-prefill"],
         "at_hubert_train_shape": fa_timing["hubert-train"],
         # deepseek-coder-33b's prefill (GQA 56/8, a group of 7) and
         # h2o-danube-3-4b's past its window (B 4, S 5000, Dh 120)
         "at_deepseek_shape": fa_timing["deepseek-prefill"],
         "at_h2o_long_shape": fa_timing["h2o-long-prefill"],
         # minicpm-2b's prefill on one rank of phase 41's (1, 4) mesh
         "at_minicpm_rank_shape": fa_timing["minicpm-rank-prefill"],
         # phase 44 (d): recurrentgemma-9b's first call on rank 0 of (1, 4)
         # (4 query heads over 1 KV head, Dh 256) against the plain version
         "at_griffin_rank_shape": griffin_at_rank["flash_attention"],
         # phase 45 (b), (d): the first call on rank 0 of (1, 4) of
         # llama-3.2-vision's prefill (8 query heads over 2 KV heads, Dh
         # 128) and of hubert-xlarge's train step (4 heads of Dh 80, not
         # causal) against the plain version
         "at_vision_rank_shape": vision_at_rank,
         "at_hubert_rank_shape": hubert_at_rank["forward"],
         # minicpm-2b's train shape (B 1, S 4096, 36 heads of 64)
         "at_minicpm_train_shape": fa_timing["minicpm-train"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_bwd.cu",
         # the gradient of the TPU kernel above, which has none of its own:
         # the reference differentiates its plain attention
         # (src/repro/models/layers.py:90) with jax.grad
         "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
         # launches on its path, minicpm-2b training (4 steps and an eval),
         # all on wgmma_bf16 (checked in the train phase); times at that
         # path's shape (B 1, S 4096, 36 heads of 64), and at
         # recurrentgemma's and hubert-xlarge's train shapes, minicpm's,
         # granite's and recurrentgemma's prefill shapes and minicpm's train
         # shape at one rank's 9 heads
         "launches": train_launches["flash_attention_bwd"],
         "launches_by_route": {
             f"{ARCH} train": train_routes["flash_attention_bwd"],
             f"{GRIFFIN_ARCH} train":
                 griffin_train_routes["flash_attention_bwd"],
             f"{AUDIO_ARCH} train":
                 audio_train_routes["flash_attention_bwd"],
             f"{ARCH} sharded train":
                 sharded_train_routes["flash_attention_bwd"],
             f"{MOE_ARCH} sharded train":
                 moe_mesh_routes[f"{MOE_ARCH} sharded train"][
                     "flash_attention_bwd"],
             **{path: r["flash_attention_bwd"]
                for path, r in modal_routes.items()
                if modal_launches[path]["flash_attention_bwd"]}},
         "launches_by_path": {
             f"{ARCH} train": train_launches["flash_attention_bwd"],
             f"{ARCH} sharded train": sharded_train["flash_attention_bwd"],
             f"{MOE_ARCH} sharded train":
                 moe_mesh_launches[f"{MOE_ARCH} sharded train"][
                     "flash_attention_bwd"],
             f"{GRIFFIN_ARCH} train": griffin_train["flash_attention_bwd"],
             f"{AUDIO_ARCH} train": audio_train["flash_attention_bwd"],
             f"{MOE_ARCH} train": moe_train["flash_attention_bwd"],
             "pipeline engine":
                 engine_real["launches"]["flash_attention_bwd"],
             "pipeline service":
                 service["launches"]["flash_attention_bwd"],
             "pipeline recovery":
                 recovery["launches"]["flash_attention_bwd"],
             # phase 45 (c), (d): hubert-xlarge's 2 train steps on a (1, 1)
             # mesh and one on rank 0 of (1, 4)
             **{path: n["flash_attention_bwd"]
                for path, n in modal_launches.items()
                if n["flash_attention_bwd"]}},
         # phase 45 (d): at the first call's shapes on rank 0 of (1, 4) of
         # hubert-xlarge's train step (4 heads of Dh 80, not causal)
         "at_hubert_rank_shape": hubert_at_rank["backward"],
         **bwd_timing},
        {"name": "moe_gmm", "route": "cuda",
         "source": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
         "replaces": "src/repro/kernels/moe_gmm/kernel.py:55",
         # launches on granite-moe's serving, all on wgmma_bf16 (checked in
         # its serve phase); times at its prefill shape with every row live,
         # and in "at_decode_routed" at its decode with a routing's fills
         # (mixtral-8x7b's in "at_mixtral_decode_routed"); under grad it
         # runs in ExpertFFNFunction, whose backward is moe_gmm_bwd below
         "launches": moe_launches["moe_gmm"],
         "launches_by_route": routes[MOE_ARCH]["moe_gmm"],
         "launches_by_path": {
             MOE_ARCH: moe_launches["moe_gmm"],
             f"{MOE_ARCH} train": moe_train["moe_gmm"],
             **{arch: n["moe_gmm"] for arch, n in zoo_launches.items()
                if n["moe_gmm"]},
             # phase 43 (a): on a (1, 1) mesh, 3 prefills and
             # MOE_MESH_DECODE decode steps under each ruleset, and
             # MOE_MESH_TRAIN_STEPS train steps of 4 layers; (b) 3
             # prefills on rank 0 of (1, 4)
             **{path: n["moe_gmm"] for path, n in moe_mesh_launches.items()}},
         "launches_by_route_by_path": {
             **{arch: routes[arch]["moe_gmm"] for arch in
                (MOE_ARCH, *(a for a, n in zoo_launches.items()
                             if n["moe_gmm"]))},
             **{path: r["moe_gmm"] for path, r in moe_mesh_routes.items()}},
         # phase 43 (b): rank 0 of a (1, 4) mesh of fake ranks, its local
         # buckets and weights, launches, route, CUDA-event ms a launch and
         # the first call's error against the plain version
         "at_rank_shapes": moe_at_rank,
         "launches_by_route_train": moe_train_routes["moe_gmm"],
         **gmm_timing},
        {"name": "moe_gmm_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm_bwd.cu",
         # the gradient of the TPU kernel above, which has none of its own:
         # the reference differentiates its plain einsums with jax.grad
         "replaces": "src/repro/kernels/moe_gmm/kernel.py:55",
         # launches on its path, granite-moe-3b-a800m's full-depth training
         # through the gather dispatch (4 steps and an eval), all on
         # wgmma_bf16 (checked in the train phase); times at that path's
         # shape (E 40, C 1024, d 1536, f 512, a routing's live rows) beside
         # the plain backward from the same call
         "launches": moe_train["moe_gmm_bwd"],
         "launches_by_route": moe_train_routes["moe_gmm_bwd"],
         "launches_by_path": {
             f"{MOE_ARCH} train": moe_train["moe_gmm_bwd"],
             # phase 43 (a): MOE_MESH_TRAIN_STEPS train steps of 4 layers
             # on a (1, 1) mesh under each ruleset
             **{path: n["moe_gmm_bwd"] for path, n in
                moe_mesh_launches.items() if n["moe_gmm_bwd"]}},
         **gmm_bwd_timing},
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan/kernel.py:55",
         # launches on recurrentgemma-9b's serving, all on fused_bias
         # (checked in its serve phase); times at its prefill shape on that
         # route, and in "at_gates_route" on whole float32 gates
         "launches": griffin_launches["rglru_scan"],
         "launches_by_route": routes[GRIFFIN_ARCH]["rglru_scan"],
         "launches_by_path": {
             GRIFFIN_ARCH: griffin_launches["rglru_scan"],
             f"{GRIFFIN_ARCH} train": griffin_train["rglru_scan"],
             # phase 44: a prefill on a (1, 1) mesh and on rank 0 of
             # (1, 4), 2 train steps of 6 layers on the (1, 1) mesh
             **{path: n["rglru_scan"] for path, n in
                rec_mesh_launches.items() if n["rglru_scan"]}},
         "launches_by_route_by_path": {
             path: r["rglru_scan"] for path, r in rec_mesh_routes.items()
             if rec_mesh_launches[path]["rglru_scan"]},
         # phase 44 (d): its first call on rank 0 of (1, 4), (4, 1000,
         # 1024), against the plain version and timed beside its bound
         "at_rank_shape": griffin_at_rank["rglru_scan"],
         **rg_timing},
        {"name": "rglru_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/rglru_scan/csrc/"
                   "rglru_scan_bwd.cu",
         # the gradient of the TPU kernel above, which has none of its own:
         # the reference differentiates its plain recurrence
         # (src/repro/models/rglru.py:41) with jax.grad
         "replaces": "src/repro/kernels/rglru_scan/kernel.py:55",
         # launches on its path, recurrentgemma-9b training (4 steps and an
         # eval), all on fused_bias (checked in the train phase); times at
         # that path's shape (B 1, S 4096, D 4096, bf16)
         "launches": griffin_train["rglru_scan_bwd"],
         "launches_by_route": griffin_train_routes["rglru_scan_bwd"],
         # phase 44 (b): 2 train steps of 6 layers on a (1, 1) mesh
         "launches_by_path": {
             f"{GRIFFIN_ARCH} train": griffin_train["rglru_scan_bwd"],
             f"{GRIFFIN_ARCH} sharded train": rec_mesh_launches[
                 f"{GRIFFIN_ARCH} sharded train"]["rglru_scan_bwd"]},
         **rg_bwd_timing},
        {"name": "mlstm_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/mlstm_scan/csrc/mlstm_scan.cu",
         "replaces": "src/repro/kernels/mlstm_scan/kernel.py:85",
         # launches on xlstm-1.3b's serving, all on the route in
         # "kernel_route" (checked in its serve phase); times at its prefill
         # shape, with each pass and the scalar bf16 kernels beside them
         "launches": xlstm_launches["mlstm_scan"],
         "launches_by_route": routes[XLSTM_ARCH]["mlstm_scan"],
         "launches_by_path": {
             XLSTM_ARCH: xlstm_launches["mlstm_scan"],
             f"{XLSTM_ARCH} train": xlstm_train["mlstm_scan"],
             # phase 44: a prefill of 4 layers on a (1, 1) mesh and on rank
             # 0 of (1, 4), 2 train steps of 4 layers on the (1, 1) mesh
             **{path: n["mlstm_scan"] for path, n in
                rec_mesh_launches.items() if n["mlstm_scan"]}},
         "launches_by_route_by_path": {
             path: r["mlstm_scan"] for path, r in rec_mesh_routes.items()
             if rec_mesh_launches[path]["mlstm_scan"]},
         # phase 44 (d): its first call on rank 0 of (1, 4), one head of
         # Dh 1024, against the plain version and timed beside its bound
         "at_rank_shape": xlstm_at_rank["mlstm_scan"],
         **ml_timing},
        {"name": "mlstm_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/mlstm_scan/csrc/"
                   "mlstm_scan_bwd.cu",
         # the gradient of the TPU kernel above, which has none of its own:
         # the reference differentiates its plain chunkwise function
         # (src/repro/models/xlstm.py:92) with jax.grad
         "replaces": "src/repro/kernels/mlstm_scan/kernel.py:85",
         # launches on its path, xlstm-1.3b training (4 steps and an eval),
         # all on wgmma_bf16 (checked in the train phase); times at the
         # mLSTM's train_4k shape (B 1, S 4096, 4 heads of 1024, bf16),
         # with each pass and the scalar bf16 route beside them
         "launches": xlstm_train["mlstm_scan_bwd"],
         "launches_by_route": xlstm_train_routes["mlstm_scan_bwd"],
         # phase 44 (b): 2 train steps of 4 layers on a (1, 1) mesh
         "launches_by_path": {
             f"{XLSTM_ARCH} train": xlstm_train["mlstm_scan_bwd"],
             f"{XLSTM_ARCH} sharded train": rec_mesh_launches[
                 f"{XLSTM_ARCH} sharded train"]["mlstm_scan_bwd"]},
         **ml_bwd_timing},
    ]
    for k in kernels:
        check(k["route"] in ("cuda", "triton"),
              f"{k['name']}: route {k['route']!r} in the kernels line")
        # the same numbers again under short names (bound in microseconds)
        k.update(max_err=k["max_abs_err"], kernel_ms=k["ms"],
                 bound_us=k["bound_ms"] * 1e3)
    print(json.dumps({"kernels": kernels}))
    print(card)
    # the run uses one card, whatever the machine shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
